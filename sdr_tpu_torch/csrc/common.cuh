// Shared device code of the port's kernels: the shared-memory radix-2
// FFT, the Gray decode, the per-axis max-log LLR forms and a
// deterministic block reduction.
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

template <int M>
__device__ __forceinline__ int gray_to_binary(int g) {
  int b = g;
#pragma unroll
  for (int shift = 1; shift < M; shift <<= 1) b ^= b >> shift;
  return b;
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
// TR_FAST: consecutive threads take consecutive transforms (the
// channels-last tile, bank-conflict-free across channels); otherwise
// consecutive butterflies of one transform. n_tr = 2^log_tr.
template <bool TR_FAST>
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
      int t, j;
      if (TR_FAST) {
        t = w & ((1 << log_tr) - 1);
        j = w >> log_tr;
      } else {
        t = w >> (log_n - 1);
        j = w & (half - 1);
      }
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

// Division-free max-log LLRs of one axis (M <= 2) from the
// un-equalised inner product p = Re or Im of conj(h) y and h2 = |h|^2:
// with g(l) = lev^2 h2 - 2 lev p, LLR_j = (min_{S1} g - min_{S0} g) * inv_nv
// (the common p^2/h2 term cancels).
template <int M>
__device__ __forceinline__ void llr_axis_dfree(float p, float h2, float inv_nv,
                                               const AxisTables& t, float* out) {
  float d0[M], d1[M];
#pragma unroll
  for (int j = 0; j < M; ++j) d0[j] = d1[j] = 3.4e38f;
#pragma unroll
  for (int g = 0; g < (1 << M); ++g) {
    const float hl = h2 * t.lev2[g];
    const float q = p * t.two_abs[g];
    const float d = t.lev[g] >= 0.0f ? hl - q : hl + q;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if ((g >> (M - 1 - j)) & 1) d1[j] = fminf(d1[j], d);
      else d0[j] = fminf(d0[j], d);
    }
  }
#pragma unroll
  for (int j = 0; j < M; ++j) out[j] = (d1[j] - d0[j]) * inv_nv;
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
