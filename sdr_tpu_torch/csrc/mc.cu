// Kernel G: the whole Monte-Carlo link in one kernel.
//
// Replaces sdr_tpu/kernels/mc_pallas.py::mc_count_pallas (n_fft 128-512,
// SC-FDMA at <= 256) and ::_mc_count_fourstep (n_fft 1024-4096) with one
// kernel. The TPU needed two because its dense N x N DFT operands
// outgrow VMEM past 512 points and Mosaic could not lower the large
// transforms any other way; a shared-memory radix-2 FFT has neither
// limit, so one kernel covers 2^7..2^12 points.
//
// A block takes one channel b and a run of spb of its symbols (spb =
// 2^(9 - log N) below N = 512, one symbol above), and per symbol:
//   indices (keyed: kernel A's layout, word k mod 4 of counter (ch, s, k div 4, 0));
//   Gray map to PAM levels; [SC-FDMA: forward FFT, x norm/sqrt(N)];
//   x H[k] per subcarrier; inverse FFT (x norm/N, or 1/N after the
//   spread); + sigma n on the N payload samples only, sigma =
//   sqrt(nv/N/2), the noise of time sample n on kernel B's counter
//   (ch, s, cp + n, 0); forward FFT; the OFDM tail (unbiased one-tap
//   MMSE, max-log LLR) or the SC-FDE despread tail (common.cuh, shared
//   with kernel C); errors against the indices; one integer atomic per
//   block into the channel's count.
// With CP >= L-1 the per-subcarrier channel before the inverse FFT is
// the circular convolution the fast engine's time-domain FIR gives after
// the CP strip, and the CP samples' noise is stripped there, so a keyed
// pass is the fast engine's link for the same (seed, channel id), up to
// float rounding: counts agree but for decisions on near-zero LLRs.
//
// Channel state, drawn once per block on the fast engine's fading
// stream (ops/channel.py, key seed ^ ROLE_FADING): flat Rayleigh (lane
// 0, counter (ch, 0, 0)); Rician (LOS phase lane 1, diffuse lane 0);
// Jakes per symbol (lane 2, counter (ch, 0, p), 16 paths); static taps
// (lane 0, counter (ch, 0, l), x sqrt(p_l / sum p)); per-tap Jakes taps
// (lane 2, counter (ch, l, p)). H[k] of a tap set is built per bin with
// the twiddle of (k l) mod N, as kernel C's taps mode does. The injected
// mode reads idx, the N(0, 1) noise planes and the response planes
// (B, 1 | S, N) instead of drawing them (mc_pallas.py:242-247).
//
// Bound on the H100: operations. Only the seed, the channel ids and the
// (B,) counts touch device memory; per sample the kernel runs two (three
// with SC-FDMA) radix-2 FFT stages' butterflies through shared memory,
// a quarter of a Philox-4x32-10 block for the index (four indices per
// call) and one for the noise, a Box-Muller pair and
// the LLR tail. The TPU kernel ran its transforms as matmuls on the MXU;
// here they are f32 on CUDA cores.
#include "common.cuh"
#include "philox.cuh"

// Launch parameters, passed by value from kernels/_lib.py::McParams. At
// namespace scope (not in the anonymous namespace below), so that the
// extern "C" entry point that takes it keeps external linkage.
struct McParams {
  const int32_t* ch_ids;  // (B,) global channel ids
  int32_t* out;           // (B,) error counts, accumulated
  const int32_t* idx_in;  // injected (B, S, N) indices, or null (keyed)
  const float* n_re;      // injected (B, S, N) N(0, 1) noise planes
  const float* n_im;
  const float* h_re;      // injected (B, h_syms, N) response planes
  const float* h_im;
  const float* amps;      // (L,) tap amplitudes sqrt(p_l / sum p)
  const float* twr;       // forward twiddles e^{-2 pi i k/N}, k < N/2
  const float* twi;
  int B, S, log_n, cp, log_spb, n_chunks;
  int kind, n_taps, h_syms, noise;
  unsigned kp0, kp1, kn0, kn1, kf0, kf1;  // payload, noise, fading keys
  int idx_mask;
  float sigma;         // time-domain noise std per component
  float nv, inv_nv;    // subcarrier noise variance (clamped) and 1/nv
  float tx_scale;      // norm/N (OFDM) or 1/N (after the spread)
  float spread_scale;  // norm/sqrt(N) (SC-FDMA)
  float a_los, s_dif;  // Rician sqrt(K/(K+1)), sqrt(0.5/(K+1))
  float jakes_w;       // (float)(2 pi fd)
};

namespace {

// Channel kinds (the wrapper maps the channel model to these).
enum : int {
  kNone = 0,     // IDENTITY, AWGN: H = 1
  kFlat = 1,     // RAYLEIGH_FLAT: one complex gain per channel
  kRician = 2,   // RICIAN: LOS + diffuse gain per channel
  kJakes = 3,    // RAYLEIGH_TIME: one Jakes gain per symbol
  kTaps = 4,     // MULTIPATH: static taps
  kTapsSym = 5,  // MULTIPATH_TIME: per-tap Jakes taps per symbol
  kPlane = 6,    // injected response planes (B, h_syms, N)
};

constexpr int kJakesPaths = 16;
constexpr int kJakesLane = 2;

// Jakes gain of path set `row` at symbol s: (1/4) sum_p e^{i(w s cos th_p +
// ph_p)}, (th, ph) = 2 pi U on words 0 and 1 of lane 2, counter (ch, row,
// p). The products and the sum are rounded one by one as torch does
// (ops/channel.py::jakes_eval), not contracted to FMAs.
__device__ __forceinline__ void jakes_gain(const McParams& p, uint32_t ch, int row, int s,
                                           float& gr, float& gi) {
  float ar = 0.0f, ai = 0.0f;
  const float ws = __fmul_rn(p.jakes_w, (float)s);
  for (int q = 0; q < kJakesPaths; ++q) {
    const uint4 w = sdr::philox4x32_10(
        make_uint4(ch, (uint32_t)row, (uint32_t)q, (uint32_t)kJakesLane), p.kf0, p.kf1);
    const float th = __fmul_rn(sdr::uniform_01(w.x), 6.2831855f);
    const float ph = __fmul_rn(sdr::uniform_01(w.y), 6.2831855f);
    const float ang = __fadd_rn(__fmul_rn(ws, cosf(th)), ph);
    ar = __fadd_rn(ar, cosf(ang));
    ai = __fadd_rn(ai, sinf(ang));
  }
  gr = ar * 0.25f;
  gi = ai * 0.25f;
}

template <int M, bool BPSK, bool SPREAD>
__global__ void __launch_bounds__(sdr::kThreads) mc_kernel(McParams p, sdr::AxisTables tab) {
  extern __shared__ float smem[];
  const int log_n = p.log_n;
  const int N = 1 << log_n;
  const int spb = 1 << p.log_spb;
  const int L = p.n_taps;
  const int n_tp = p.kind == kTapsSym ? spb * L : (p.kind == kTaps ? L : spb);
  float* sre = smem;
  float* sim = sre + (spb << log_n);
  float* tp_r = sim + (spb << log_n);
  float* tp_i = tp_r + n_tp;
  float* red = tp_i + n_tp;
  float* bias = red + sdr::kThreads / 32;
  int* cnt = (int*)(bias + spb);
  int16_t* sidx = (int16_t*)(cnt + spb);

  const int b = blockIdx.x / p.n_chunks;
  const int s0 = (blockIdx.x - b * p.n_chunks) << p.log_spb;
  const int n_sym = min(spb, p.S - s0);
  const uint32_t ch = (uint32_t)p.ch_ids[b];
  const long long row0 = (long long)b * p.S + s0;

  // Indices and channel state.
  if ((int)threadIdx.x < spb) cnt[threadIdx.x] = 0;
  // Four indices per thread: kernel A's layout, one Philox call per quad of
  // subcarriers (N >= 128, so a quad never straddles a symbol).
  for (int q = threadIdx.x; q < (spb << (log_n - 2)); q += blockDim.x) {
    const int e = q << 2;
    const int t = e >> log_n;
    const int k = e & (N - 1);
    int v[4] = {0, 0, 0, 0};
    if (t < n_sym) {
      if (p.idx_in != nullptr) {
        const int* src = p.idx_in + ((row0 + t) << log_n) + k;
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = src[i];
      } else {
        const uint4 w = sdr::philox4x32_10(
            make_uint4(ch, (uint32_t)(s0 + t), (uint32_t)(k >> 2), 0u), p.kp0, p.kp1);
        const uint32_t m = (uint32_t)p.idx_mask;
        v[0] = (int)(w.x & m);
        v[1] = (int)(w.y & m);
        v[2] = (int)(w.z & m);
        v[3] = (int)(w.w & m);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) sidx[e + i] = (int16_t)v[i];
  }
  if (p.kind == kFlat || p.kind == kRician) {
    if (threadIdx.x == 0) {
      const uint4 w = sdr::philox4x32_10(make_uint4(ch, 0u, 0u, 0u), p.kf0, p.kf1);
      float g1, g2;
      sdr::box_muller(w.x, w.y, g1, g2);
      if (p.kind == kFlat) {
        tp_r[0] = g1 * 0.70710677f;
        tp_i[0] = g2 * 0.70710677f;
      } else {
        const uint4 u = sdr::philox4x32_10(make_uint4(ch, 0u, 0u, 1u), p.kf0, p.kf1);
        const float ph = sdr::uniform_01(u.x) * 6.2831855f;
        tp_r[0] = p.a_los * cosf(ph) + g1 * p.s_dif;
        tp_i[0] = p.a_los * sinf(ph) + g2 * p.s_dif;
      }
    }
  } else if (p.kind == kJakes) {
    if ((int)threadIdx.x < n_sym) jakes_gain(p, ch, 0, s0 + threadIdx.x, tp_r[threadIdx.x],
                                             tp_i[threadIdx.x]);
  } else if (p.kind == kTaps) {
    for (int l = threadIdx.x; l < L; l += blockDim.x) {
      const uint4 w = sdr::philox4x32_10(make_uint4(ch, 0u, (uint32_t)l, 0u), p.kf0, p.kf1);
      float g1, g2;
      sdr::box_muller(w.x, w.y, g1, g2);
      tp_r[l] = g1 * 0.70710677f * p.amps[l];
      tp_i[l] = g2 * 0.70710677f * p.amps[l];
    }
  } else if (p.kind == kTapsSym) {
    for (int e = threadIdx.x; e < n_sym * L; e += blockDim.x) {
      const int t = e / L;
      const int l = e - t * L;
      float gr, gi;
      jakes_gain(p, ch, l, s0 + t, gr, gi);
      tp_r[e] = gr * p.amps[l];
      tp_i[e] = gi * p.amps[l];
    }
  }
  __syncthreads();

  // Channel of subcarrier k of block symbol t.
  auto channel = [&](int t, int k, float& h_r, float& h_i) {
    switch (p.kind) {
      case kFlat:
      case kRician:
        h_r = tp_r[0];
        h_i = tp_i[0];
        return;
      case kJakes:
        h_r = tp_r[t];
        h_i = tp_i[t];
        return;
      case kTaps:
      case kTapsSym: {
        const float* tr = tp_r + (p.kind == kTapsSym ? t * L : 0);
        const float* ti = tp_i + (p.kind == kTapsSym ? t * L : 0);
        const int half = N >> 1;
        float ar = 0.0f, ai = 0.0f;
        for (int l = 0; l < L; ++l) {
          const int m = (k * l) & (N - 1);
          const float wr = m < half ? __ldg(p.twr + m) : -__ldg(p.twr + m - half);
          const float wi = m < half ? __ldg(p.twi + m) : -__ldg(p.twi + m - half);
          ar += tr[l] * wr - ti[l] * wi;
          ai += tr[l] * wi + ti[l] * wr;
        }
        h_r = ar;
        h_i = ai;
        return;
      }
      case kPlane: {
        const long long ho =
            (((long long)b * p.h_syms + (p.h_syms > 1 ? s0 + t : 0)) << log_n) + k;
        h_r = p.h_re[ho];
        h_i = p.h_im[ho];
        return;
      }
      default:
        h_r = 1.0f;
        h_i = 0.0f;
    }
  };
  auto apply = [&](int t, int k, float& xr, float& xi) {
    if (p.kind == kNone) return;
    float h_r, h_i;
    channel(t, k, h_r, h_i);
    const float yr = xr * h_r - xi * h_i;
    xi = xr * h_i + xi * h_r;
    xr = yr;
  };

  // TX: PAM levels, [spread], x H, bit-reversed for the inverse FFT.
  for (int e = threadIdx.x; e < (spb << log_n); e += blockDim.x) {
    const int t = e >> log_n;
    const int k = e & (N - 1);
    float xr, xi;
    sdr::pam_point<M, BPSK>(sidx[e], xr, xi);
    if (!SPREAD) apply(t, k, xr, xi);
    const int dst = (t << log_n) + sdr::bit_reverse(k, log_n);
    sre[dst] = xr;
    sim[dst] = xi;
  }
  __syncthreads();
  if (SPREAD) {
    sdr::smem_fft<false>(sre, sim, log_n, p.log_spb, N, 1, p.twr, p.twi, 1.0f);
    sdr::bitrev_rows(sre, sim, log_n, p.log_spb, [&](int t, int k, float& xr, float& xi) {
      xr *= p.spread_scale;
      xi *= p.spread_scale;
      apply(t, k, xr, xi);
    });
    __syncthreads();
  }
  sdr::smem_fft<false>(sre, sim, log_n, p.log_spb, N, 1, p.twr, p.twi, -1.0f);

  // Channel: scale, AWGN on the payload samples, bit-reversed for the RX FFT.
  sdr::bitrev_rows(sre, sim, log_n, p.log_spb, [&](int t, int n, float& xr, float& xi) {
    xr *= p.tx_scale;
    xi *= p.tx_scale;
    if (!p.noise || t >= n_sym) return;
    float g1, g2;
    if (p.n_re != nullptr) {
      const long long o = ((row0 + t) << log_n) + n;
      g1 = p.n_re[o];
      g2 = p.n_im[o];
    } else {
      const uint4 w = sdr::philox4x32_10(
          make_uint4(ch, (uint32_t)(s0 + t), (uint32_t)(p.cp + n), 0u), p.kn0, p.kn1);
      sdr::box_muller(w.x, w.y, g1, g2);
    }
    xr += p.sigma * g1;
    xi += p.sigma * g2;
  });
  __syncthreads();
  sdr::smem_fft<false>(sre, sim, log_n, p.log_spb, N, 1, p.twr, p.twi, 1.0f);

  // RX: equalise, LLR, count.
  auto index = [&](int t, int n) { return t < n_sym ? (int)sidx[(t << log_n) + n] : -1; };
  if (SPREAD) {
    sdr::despread_count_tail<M, BPSK>(sre, sim, log_n, p.log_spb, p.nv, p.twr, p.twi, tab, red,
                                      bias, cnt, channel, index);
  } else {
    int err = 0;
    for (int e = threadIdx.x; e < (spb << log_n); e += blockDim.x) {
      const int t = e >> log_n;
      const int k = e & (N - 1);
      const int v = index(t, k);
      if (v < 0) continue;
      float h_r, h_i;
      channel(t, k, h_r, h_i);
      err += sdr::mmse_bit_errors<M, BPSK>(sre[e], sim[e], h_r, h_i, p.inv_nv, tab, v);
    }
    if (err) atomicAdd(cnt, err);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int t = 0; t < spb; ++t) total += cnt[t];
    if (total) atomicAdd(p.out + b, total);
  }
}

template <int M, bool BPSK, bool SPREAD>
int launch(const McParams& p, const sdr::AxisTables& tab, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mc_kernel<M, BPSK, SPREAD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)p.B * p.n_chunks;
  mc_kernel<M, BPSK, SPREAD><<<(unsigned)blocks, sdr::kThreads, smem, st>>>(p, tab);
  return 0;
}

}  // namespace

// One Monte-Carlo pass; counts are added into p.out (zeroed by the caller).
extern "C" int sdr_mc_count(McParams p, int bits_per_axis, int bpsk, int spread,
                            sdr::AxisTables tab, void* stream) {
  if ((long long)p.B * p.S == 0) return 0;
  // log_n >= 7 (N >= 128, kernels/mc.py's MIN_N_FFT): the keyed draw takes
  // whole quads of subcarriers within one symbol.
  if (p.log_n < 7 || p.log_n > 12 || p.n_taps < 0 || p.idx_mask > 0x7FFF)
    return (int)cudaErrorInvalidValue;
  // No more symbols per block than the channel has.
  p.log_spb = p.log_n >= 9 ? 0 : 9 - p.log_n;
  while (p.log_spb > 0 && (1 << (p.log_spb - 1)) >= p.S) --p.log_spb;
  const int spb = 1 << p.log_spb;
  p.n_chunks = (p.S + spb - 1) / spb;
  if ((long long)p.B * p.n_chunks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const size_t tile = (size_t)spb << p.log_n;
  const size_t n_tp = p.kind == kTapsSym ? (size_t)spb * p.n_taps
                                         : (p.kind == kTaps ? (size_t)p.n_taps : (size_t)spb);
  const size_t smem = sizeof(float) * (2 * tile + 2 * n_tp + sdr::kThreads / 32 + spb) +
                      sizeof(int) * spb + sizeof(int16_t) * tile;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = 0;
  SDR_DISPATCH_MOD(bits_per_axis, bpsk,
    rc = spread ? launch<M, BPSK, true>(p, tab, smem, st) : launch<M, BPSK, false>(p, tab, smem, st))
  if (rc) return rc;
  return (int)cudaGetLastError();
}
