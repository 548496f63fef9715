// Shared device code of the port's kernels: the complex FIR tap of kernels
// B and E, the shared-memory radix-2 FFT and its bit-reversal pass, the
// Gray map, the per-axis max-log LLR forms and hard decisions, the OFDM and
// SC-FDE receive tails with their error counts, and a deterministic block
// reduction.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace sdr {

constexpr int kThreads = 256;  // threads per block of every kernel here

// Per-modulation constants, filled host-side (sdr_tpu_torch/kernels/_lib.py)
// in the float64-then-float32 order the JAX kernels use, and passed by
// value. Index g is the per-axis Gray index.
struct AxisTables {
  float lev[32];      // normalised PAM level of Gray index g
  float lev2[32];     // lev^2 (division-free channels-last tail)
  float two_abs[32];  // 2|lev|
  float norm2;        // norm^2 (Gray fold recursion scale)
  float inorm;        // 1/norm
};

// One tap of a complex FIR: acc += g * w, with its rounding pinned (a
// multiply, a fused multiply-add and an add a component, in that order), so
// kernels B and E and every code path of each round alike wherever nvcc
// would otherwise contract the sums into fused multiply-adds its own way.
__device__ __forceinline__ void cmac(float2& acc, float2 g, float wr, float wi) {
  acc.x = __fadd_rn(acc.x, __fmaf_rn(g.x, wr, -__fmul_rn(g.y, wi)));
  acc.y = __fadd_rn(acc.y, __fmaf_rn(g.x, wi, __fmul_rn(g.y, wr)));
}

template <int M>
__device__ __forceinline__ int gray_to_binary(int g) {
  int b = g;
#pragma unroll
  for (int shift = 1; shift < M; shift <<= 1) b ^= b >> shift;
  return b;
}

// Whether tone k (0 <= k < 2^22) is on the pilot comb of spacing p, i.e.
// k % p == 0, with inv_p = 1/p rounded to float: q = floor((k + 1/2) inv_p)
// is floor(k/p) exactly, since (k + 1/2)/p stays at least 1/(2p) from an
// integer and the two roundings move it by at most (k/p) 2^-23. Five
// instructions where a remainder by a run-time p takes about twenty.
__device__ __forceinline__ bool on_comb(int k, int p, float inv_p) {
  return k == __float2int_rz(((float)k + 0.5f) * inv_p) * p;
}

__device__ __forceinline__ int bit_reverse(int n, int log_n) {
  return (int)(__brev((unsigned)n) >> (32 - log_n));
}

// In-place radix-2 decimation-in-time FFTs of n_tr transforms of
// N = 2^log_n points held in shared memory, input in bit-reversed order,
// output in natural order. Element i of transform t is at
// t*tr_stride + i*el_stride. twr/twi are the forward twiddles
// e^{-2 pi i k/N}, k < N/2; wsign = +1 gives the forward (unscaled)
// transform, -1 the inverse (unscaled; the caller applies 1/N).
// Consecutive threads take consecutive butterflies of one transform.
// n_tr = 2^log_tr.
__device__ __forceinline__ void smem_fft(float* re, float* im, int log_n, int log_tr,
                                         int tr_stride, int el_stride,
                                         const float* __restrict__ twr,
                                         const float* __restrict__ twi, float wsign) {
  const int half = 1 << (log_n - 1);
  const int total = half << log_tr;
  for (int s = 0; s < log_n; ++s) {
    const int h = 1 << s;
    const int tw_shift = log_n - 1 - s;
    for (int w = threadIdx.x; w < total; w += blockDim.x) {
      const int t = w >> (log_n - 1);
      const int j = w & (half - 1);
      const int pos = j & (h - 1);
      const int i0 = ((j - pos) << 1) + pos;
      const int a0 = t * tr_stride + i0 * el_stride;
      const int a1 = a0 + h * el_stride;
      const float wr = __ldg(twr + (pos << tw_shift));
      const float wi = wsign * __ldg(twi + (pos << tw_shift));
      const float xr = re[a1], xi = im[a1];
      const float br = xr * wr - xi * wi;
      const float bi = xr * wi + xi * wr;
      const float ar = re[a0], ai = im[a0];
      re[a0] = ar + br;
      im[a0] = ai + bi;
      re[a1] = ar - br;
      im[a1] = ai - bi;
    }
    __syncthreads();
  }
}

// Max-log LLRs of one axis by the per-level distance scan (L <= 4):
// LLR_j = (min_{bit j = 1} (v - lev)^2 - min_{bit j = 0} (v - lev)^2) * inv_eff.
template <int M>
__device__ __forceinline__ void llr_axis_scan(float v, float inv_eff, const AxisTables& t,
                                              float* out) {
  float d0[M], d1[M];
#pragma unroll
  for (int j = 0; j < M; ++j) d0[j] = d1[j] = 3.4e38f;
#pragma unroll
  for (int g = 0; g < (1 << M); ++g) {
    const float e = v - t.lev[g];
    const float d = e * e;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if ((g >> (M - 1 - j)) & 1) d1[j] = fminf(d1[j], d);
      else d0[j] = fminf(d0[j], d);
    }
  }
#pragma unroll
  for (int j = 0; j < M; ++j) out[j] = (d1[j] - d0[j]) * inv_eff;
}

// Exact max-log LLRs of one axis by the Gray fold recursion (L >= 8):
// the MSB metric in the unnormalised domain is
// -sign(z) (q+1)(2|z| - (q-1)) with q the nearest positive level, and
// the other bits are the same problem on z' = Lc/2 - |z|.
template <int M>
__device__ __forceinline__ void llr_axis_fold(float v, float inv_eff, const AxisTables& t,
                                              float* out) {
  const float scale = inv_eff * t.norm2;
  float z = v * t.inorm;
  int lc = 1 << M;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const float az = fabsf(z);
    const int half = lc >> 1;
    const float q = 2.0f * fminf(fmaxf(rintf((az - 1.0f) * 0.5f), 0.0f), (float)(half - 1)) + 1.0f;
    const float sg = z > 0.0f ? 1.0f : (z < 0.0f ? -1.0f : 0.0f);
    out[j] = (-sg * ((q + 1.0f) * (2.0f * az - (q - 1.0f)))) * scale;
    z = (float)half - az;
    lc = half;
  }
}

// Un-normalised PAM level 2·gray_to_binary(g) - (2^M - 1) of Gray index g,
// and the Gray index of level +a.
template <int M>
__host__ __device__ constexpr int pam_level(int g) {
  int b = g;
  for (int shift = 1; shift < M; shift <<= 1) b ^= b >> shift;
  return 2 * b - ((1 << M) - 1);
}
template <int M>
__host__ __device__ constexpr int gray_of_level(int a) {
  int g = 0;
  while (pam_level<M>(g) != a) ++g;
  return g;
}

// Division-free max-log LLRs of one axis (M <= 2) from the
// un-equalised inner product p = Re or Im of conj(h) y and h2 = |h|^2:
// with g(l) = lev^2 h2 - 2 lev p, LLR_j = (min_{S1} g - min_{S0} g) * inv_nv
// (the common p^2/h2 term cancels). Each product is taken once per level
// magnitude (lev2 and two_abs of the levels +a and -a are the same floats)
// and each level's sign is a compile-time constant.
template <int M>
__device__ __forceinline__ void llr_axis_dfree(float p, float h2, float inv_nv,
                                               const AxisTables& t, float* out) {
  constexpr int L = 1 << M;
  float hl[L / 2], q[L / 2], d[L];
#pragma unroll
  for (int u = 0; u < L / 2; ++u) {
    hl[u] = h2 * t.lev2[gray_of_level<M>(2 * u + 1)];
    q[u] = p * t.two_abs[gray_of_level<M>(2 * u + 1)];
  }
#pragma unroll
  for (int g = 0; g < L; ++g) {
    const int a = pam_level<M>(g), u = ((a > 0 ? a : -a) - 1) / 2;
    d[g] = a > 0 ? hl[u] - q[u] : hl[u] + q[u];
  }
#pragma unroll
  for (int j = 0; j < M; ++j) {
    float d0 = 3.4e38f, d1 = 3.4e38f;
#pragma unroll
    for (int g = 0; g < L; ++g) {
      if ((g >> (M - 1 - j)) & 1) d1 = fminf(d1, d[g]);
      else d0 = fminf(d0, d[g]);
    }
    out[j] = (d1 - d0) * inv_nv;
  }
}

// Sum over the block in a fixed order (warp shuffles, then warp 0 over
// the per-warp partials): the same bits on every run. Valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  v = (int)threadIdx.x < n_warps ? scratch[threadIdx.x] : 0.0f;
  if (warp == 0) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// Un-normalised PAM point of symbol index v: per axis 2*gray_to_binary(g)
// - (L-1), I from the high m bits, Q from the low m bits (BPSK: I only).
template <int M, bool BPSK>
__device__ __forceinline__ void pam_point(int v, float& xr, float& xi) {
  constexpr int L = 1 << M;
  if (BPSK) {
    xr = (float)(2 * gray_to_binary<M>(v) - (L - 1));
    xi = 0.0f;
  } else {
    xr = (float)(2 * gray_to_binary<M>(v >> M) - (L - 1));
    xi = (float)(2 * gray_to_binary<M>(v & (L - 1)) - (L - 1));
  }
}

// Max-log LLRs of one equalised point (sr, si) scaled by inv_eff (level
// scan for L <= 4, Gray fold recursion for L >= 8; I bits then Q bits, MSB
// first): llr[0 .. BPS-1].
template <int M, bool BPSK>
__device__ __forceinline__ void scaled_llrs(float sr, float si, float inv_eff,
                                            const AxisTables& tab, float* llr) {
  if constexpr (M <= 2) {
    llr_axis_scan<M>(sr, inv_eff, tab, llr);
    if constexpr (!BPSK) llr_axis_scan<M>(si, inv_eff, tab, llr + M);
  } else {
    llr_axis_fold<M>(sr, inv_eff, tab, llr);
    llr_axis_fold<M>(si, inv_eff, tab, llr + M);
  }
}

// Hard-decision bit errors of one equalised point (sr, si) against index
// v: the scaled max-log LLRs, bit = LLR < 0.
template <int M, bool BPSK>
__device__ __forceinline__ int scaled_bit_errors(float sr, float si, float inv_eff,
                                                 const AxisTables& tab, int v) {
  constexpr int BPS = BPSK ? 1 : 2 * M;
  float llr[BPS];
  scaled_llrs<M, BPSK>(sr, si, inv_eff, tab, llr);
  int err = 0;
#pragma unroll
  for (int j = 0; j < BPS; ++j) err += (int)(llr[j] < 0.0f) != ((v >> (BPS - 1 - j)) & 1);
  return err;
}

// What the OFDM tone tail takes from h alone: h, 1/max(|h|^2, 1e-12) and
// the LLR scale |h|^2 / nv (built once where h serves many symbols).
struct OneTap {
  float hr, hi, inv_h2, eff;
};
__device__ __forceinline__ OneTap one_tap(float h_r, float h_i, float inv_nv) {
  const float h2 = h_r * h_r + h_i * h_i;
  return OneTap{h_r, h_i, 1.0f / fmaxf(h2, 1e-12f), h2 * inv_nv};
}

// The OFDM tone tail: unbiased one-tap equalisation s = conj(h) y /
// max(|h|^2, 1e-12), LLRs scaled by |h|^2 / nv into llr[0 .. BPS-1].
template <int M, bool BPSK>
__device__ __forceinline__ void one_tap_llrs(float yr, float yi, const OneTap& g,
                                             const AxisTables& tab, float* llr) {
  const float sr = (g.hr * yr + g.hi * yi) * g.inv_h2;
  const float si = (g.hr * yi - g.hi * yr) * g.inv_h2;
  scaled_llrs<M, BPSK>(sr, si, g.eff, tab, llr);
}
template <int M, bool BPSK>
__device__ __forceinline__ void mmse_llrs(float yr, float yi, float h_r, float h_i, float inv_nv,
                                          const AxisTables& tab, float* llr) {
  one_tap_llrs<M, BPSK>(yr, yi, one_tap(h_r, h_i, inv_nv), tab, llr);
}

// The OFDM tone tail's bit errors against v.
template <int M, bool BPSK>
__device__ __forceinline__ int mmse_bit_errors(float yr, float yi, float h_r, float h_i,
                                               float inv_nv, const AxisTables& tab, int v) {
  constexpr int BPS = BPSK ? 1 : 2 * M;
  float llr[BPS];
  mmse_llrs<M, BPSK>(yr, yi, h_r, h_i, inv_nv, tab, llr);
  int err = 0;
#pragma unroll
  for (int j = 0; j < BPS; ++j) err += (int)(llr[j] < 0.0f) != ((v >> (BPS - 1 - j)) & 1);
  return err;
}

// The hard decisions of one tone as a BPS-bit word, bit j (MSB first: the
// I bits, then the Q bits) set where the tone's max-log LLR j is negative
// (kernels C and F count with it). That is the sign of llr_axis_fold
// without its magnitudes: LLR_j < 0 where z_j > 0, with z_0 the equalised
// axis over the PAM norm and z_{j+1} = L/2^{j+1} - |z_j|; here taken on
// w_j = z_j·|h|^2·norm, so w_0 = Re or Im of conj(h) y and no division is
// needed. It holds for every L (the division-free LLRs of L <= 4 have the
// same signs); rounding can flip only a bit whose LLR is 0 to rounding.
template <int M>
__device__ __forceinline__ int axis_bits(float w, float unit) {
  int bits = 0;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    bits = (bits << 1) | (int)(w > 0.0f);
    w = (float)(1 << (M - 1 - j)) * unit - fabsf(w);
  }
  return bits;
}

template <int M, bool BPSK>
__device__ __forceinline__ int hard_bits(float yr, float yi, float h_r, float h_i, float norm) {
  const float unit = (h_r * h_r + h_i * h_i) * norm;
  const int bits_i = axis_bits<M>(h_r * yr + h_i * yi, unit);
  if constexpr (BPSK) return bits_i;
  else return (bits_i << M) | axis_bits<M>(h_r * yi - h_i * yr, unit);
}

// v, hidden from the optimiser: what is computed from it inside a loop
// stays inside (hoisted sets of per-point addresses or twiddles spill).
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}
__device__ __forceinline__ long long opaque(long long v) {
  asm volatile("" : "+l"(v));
  return v;
}

// V consecutive floats from src (aligned to 4V bytes), through the
// read-only path.
template <int V>
__device__ __forceinline__ void load_run(const float* __restrict__ src, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(src));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else if constexpr (V == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(src));
    v[0] = x.x, v[1] = x.y;
  } else {
    v[0] = __ldg(src);
  }
}

// Stores n consecutive floats at dst (n a compile-time count), as 16-byte
// stores where n is a multiple of 4 and 8-byte ones where it is even; the
// caller guarantees dst is aligned to that width.
template <int NV>
__device__ __forceinline__ void store_run(float* __restrict__ dst, const float* v) {
  if constexpr (NV % 4 == 0) {
#pragma unroll
    for (int j = 0; j < NV; j += 4)
      *reinterpret_cast<float4*>(dst + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else if constexpr (NV % 2 == 0) {
#pragma unroll
    for (int j = 0; j < NV; j += 2) *reinterpret_cast<float2*>(dst + j) = make_float2(v[j], v[j + 1]);
  } else {
#pragma unroll
    for (int j = 0; j < NV; ++j) dst[j] = v[j];
  }
}

// Elementwise f(t, n, re, im) over n_tr = 2^log_tr rows of N = 2^log_n
// points in shared memory, each row left in bit-reversed order (the
// input order of smem_fft). Each pair (n, bitrev(n)) is handled by one
// thread, so the pass is race-free; the caller synchronises before and
// after.
template <class F>
__device__ __forceinline__ void bitrev_rows(float* re, float* im, int log_n, int log_tr, F f) {
  const int N = 1 << log_n;
  for (int e = threadIdx.x; e < (N << log_tr); e += blockDim.x) {
    const int t = e >> log_n;
    const int n = e & (N - 1);
    const int r = bit_reverse(n, log_n);
    if (r < n) continue;
    float ar = re[e], ai = im[e];
    f(t, n, ar, ai);
    if (r == n) {
      re[e] = ar;
      im[e] = ai;
      continue;
    }
    const int o = (t << log_n) + r;
    float br = re[o], bi = im[o];
    f(t, r, br, bi);
    re[e] = br;
    im[e] = bi;
    re[o] = ar;
    im[o] = ai;
  }
}

// The SC-FDE (full-grid SC-FDMA) equaliser over n_tr = 2^log_tr post-FFT
// rows of N = 2^log_n tones held in shared memory in natural order (the
// port of demod_pallas.py::equalize_despread_llr_bits, up to the LLRs):
//   per tone the biased MMSE conj(H) Y / (|H|^2 + nv);
//   per row the tone mean b = max(mean(|H|^2 / (|H|^2 + nv)), 1e-9),
//   reduced in a fixed order (block_sum), left in bias[t];
//   the N-point inverse DFT, unscaled (the despread), left in sre/sim in
//   natural order.
// hfn(t, k, hr, hi) gives the channel of tone k of row t. red: kThreads/32
// floats; bias: n_tr floats.
template <class HFn>
__device__ __forceinline__ void despread_equalize(float* sre, float* sim, int log_n, int log_tr,
                                                  float nv, const float* __restrict__ twr,
                                                  const float* __restrict__ twi, float* red,
                                                  float* bias, HFn hfn) {
  const int N = 1 << log_n;
  for (int t = 0; t < (1 << log_tr); ++t) {
    float acc = 0.0f;
    for (int k = threadIdx.x; k < N; k += blockDim.x) {
      float h_r, h_i;
      hfn(t, k, h_r, h_i);
      const float h2 = h_r * h_r + h_i * h_i;
      acc += h2 / (h2 + nv);
    }
    const float tot = block_sum(acc, red);
    if (threadIdx.x == 0) bias[t] = fmaxf(tot / (float)N, 1e-9f);
    __syncthreads();
  }
  bitrev_rows(sre, sim, log_n, log_tr, [&](int t, int k, float& yr, float& yi) {
    float h_r, h_i;
    hfn(t, k, h_r, h_i);
    const float inv_d = 1.0f / (h_r * h_r + h_i * h_i + nv);
    const float sr = (h_r * yr + h_i * yi) * inv_d;
    yi = (h_r * yi - h_i * yr) * inv_d;
    yr = sr;
  });
  __syncthreads();
  smem_fft(sre, sim, log_n, log_tr, N, 1, twr, twi, -1.0f);
}

// After despread_equalize: f(t, n, sr, si, sinr) for time symbol n of every
// row t, with the symbol scaled by 1/(sqrt(N) b) and the SINR
// b / max(1 - b, 1e-9) at which its max-log LLRs are taken.
template <class F>
__device__ __forceinline__ void despread_for_each(const float* sre, const float* sim, int log_n,
                                                  int log_tr, const float* bias, F f) {
  const int N = 1 << log_n;
  const float inv_sqrt_n = 1.0f / sqrtf((float)N);
  for (int e = threadIdx.x; e < (N << log_tr); e += blockDim.x) {
    const int t = e >> log_n;
    const float b = bias[t];
    const float scale = inv_sqrt_n / b;
    const float sinr = b / fmaxf(1.0f - b, 1e-9f);
    f(t, e & (N - 1), sre[e] * scale, sim[e] * scale, sinr);
  }
}

// The SC-FDE receive tail with its error count: despread_equalize, then
// max-log LLRs counted against the TIME-domain indices. idxfn(t, n) gives
// the transmitted index of time symbol n of row t, or -1 for a row that is
// not counted. Each row's errors are added to cnt[t] (shared, integer
// atomics: exact in any order).
template <int M, bool BPSK, class HFn, class IdxFn>
__device__ __forceinline__ void despread_count_tail(float* sre, float* sim, int log_n, int log_tr,
                                                    float nv, const float* __restrict__ twr,
                                                    const float* __restrict__ twi,
                                                    const AxisTables& tab, float* red,
                                                    float* bias, int* cnt, HFn hfn,
                                                    IdxFn idxfn) {
  despread_equalize(sre, sim, log_n, log_tr, nv, twr, twi, red, bias, hfn);
  despread_for_each(sre, sim, log_n, log_tr, bias,
                    [&](int t, int n, float sr, float si, float sinr) {
                      const int v = idxfn(t, n);
                      if (v < 0) return;
                      const int err = scaled_bit_errors<M, BPSK>(sr, si, sinr, tab, v);
                      if (err) atomicAdd(cnt + t, err);
                    });
}

// Sums n per-block partials in a fixed order into out[0] (one block of
// 1024 threads): the second pass of the deterministic LLR sums.
static __global__ void __launch_bounds__(1024)
sum_partials_kernel(const float* __restrict__ partials, int n, float* __restrict__ out) {
  __shared__ float scratch[32];
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += partials[i];
  const float v = block_sum(acc, scratch);
  if (threadIdx.x == 0) out[0] = v;
}

}  // namespace sdr

// Modulation dispatch: bits per axis 1 (BPSK or QPSK) .. 5 (1024-QAM).
#define SDR_DISPATCH_MOD(bpa, bpsk, ...)                                   \
  switch (bpa) {                                                           \
    case 1:                                                                \
      if (bpsk) { constexpr int M = 1; constexpr bool BPSK = true; __VA_ARGS__; } \
      else { constexpr int M = 1; constexpr bool BPSK = false; __VA_ARGS__; }     \
      break;                                                               \
    case 2: { constexpr int M = 2; constexpr bool BPSK = false; __VA_ARGS__; } break; \
    case 3: { constexpr int M = 3; constexpr bool BPSK = false; __VA_ARGS__; } break; \
    case 4: { constexpr int M = 4; constexpr bool BPSK = false; __VA_ARGS__; } break; \
    case 5: { constexpr int M = 5; constexpr bool BPSK = false; __VA_ARGS__; } break; \
    default: return (int)cudaErrorInvalidValue;                            \
  }

// Index-plane element type dispatch (int8 / int16 / int32).
#define SDR_DISPATCH_IDX(idx_bytes, ...)                                   \
  switch (idx_bytes) {                                                     \
    case 1: { typedef int8_t IdxT; __VA_ARGS__; } break;                   \
    case 2: { typedef int16_t IdxT; __VA_ARGS__; } break;                  \
    case 4: { typedef int32_t IdxT; __VA_ARGS__; } break;                  \
    default: return (int)cudaErrorInvalidValue;                            \
  }
