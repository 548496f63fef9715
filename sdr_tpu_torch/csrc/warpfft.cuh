// The warp-resident transform shared by kernel G (csrc/mc.cuh) and the
// warp-group forms of kernels B (csrc/tx_rows.cuh) and C
// (csrc/demod_rows.cuh), and what those two forms share around it: a group of G warps holds one
// N-point symbol in registers, R points a lane, N = 32·R·G, and runs its
// DFTs across lanes by shuffles and in registers, with no bit-reversal
// pass and, for G = 1, no barrier.
//
// Every lane knows the index of each point it holds. With A = N/32:
//   tone layout: point r of thread (w, lane) is index A*lane + G*r + w;
//   time layout: point j*G + d is index bitrev5(lane) + 32*(w + G*j) + 32*R*d.
// T1 takes the tone layout to the time layout: the 32-point DFT across
// the lanes as decimation in frequency (five __shfl_xor_sync stages,
// natural lane order in, bit-reversed out), the twiddle
// W_N^{bitrev5(lane) (w + G r)}, the R-point DFT in registers, and for
// G > 1 the twiddle W_A^{c w}, one exchange through the group's shared
// buffer and G-point DFTs in registers. T2 runs the same steps backwards
// (the cross-lane stages as decimation in time, bit-reversed in, natural
// out), from the time layout to the tone layout. Either runs forward or
// inverse, unscaled. The twiddles come from shared tables that
// build_tables fills once a block. B's and C's forms take a run of kRun
// symbols of one channel a block, copy each symbol's index row into a
// group's shared stage by cp.async, and pass the points once through a
// padded stage (stage_stride) between the tone layout and natural order.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "regfft.cuh"

namespace sdr {

constexpr unsigned kFull = 0xffffffffu;
// Symbols of one channel a block of B's or C's warp-group form takes.
constexpr int kRun = 32;

// Float2 stride of a stage's rows: writes (r·G + w)·SP + lane (the tone
// layout) and reads in natural order both conflict-free a half-warp.
__host__ __device__ constexpr int stage_stride(int A) { return 32 + (A >= 16 ? 1 : 16 / A); }

// Index k of a staged index row of width `bytes`.
__device__ __forceinline__ int staged_index(const unsigned char* ix, int bytes, int k) {
  if (bytes == 1) return reinterpret_cast<const int8_t*>(ix)[k];
  if (bytes == 2) return reinterpret_cast<const int16_t*>(ix)[k];
  return reinterpret_cast<const int32_t*>(ix)[k];
}

// Copies `bytes` (a multiple of 16, both ends 16-byte aligned) from device
// to shared memory by cp.async, 16 bytes a thread and step, thread t of n;
// the copies land by cp_async_wait_all.
__device__ __forceinline__ void copy_async(void* dst, const void* src, int bytes, int t, int n) {
  for (int c = 16 * t; c < bytes; c += 16 * n) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     (unsigned)__cvta_generic_to_shared(static_cast<char*>(dst) + c)),
                 "l"(static_cast<const char*>(src) + c)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ int brev5(int lane) { return (int)(__brev((unsigned)lane) >> 27); }

// W_N^m (forward), 0 <= m < N = 2^log_n, from the half-circle table
// twr/twi (e^{-2 pi i k/N}, k < N/2).
__device__ __forceinline__ float2 w_table(const float* __restrict__ twr,
                                          const float* __restrict__ twi, int log_n, int m) {
  const int half = 1 << (log_n - 1);
  if (m < half) return make_float2(__ldg(twr + m), __ldg(twi + m));
  return make_float2(-__ldg(twr + m - half), -__ldg(twi + m - half));
}

// x *= w (INV: x *= conj(w)).
template <bool INV>
__device__ __forceinline__ void cmul(float& xr, float& xi, float2 w) {
  const float wi = INV ? -w.y : w.y;
  const float r = xr;
  xr = r * w.x - xi * wi;
  xi = r * wi + xi * w.x;
}

// The R-point DFT of a thread's points in registers, forward or inverse
// (the inverse by conjugation), unscaled, natural order in and out.
template <int R, bool INV>
__device__ __forceinline__ void fft_dir(float (&vr)[R], float (&vi)[R]) {
  constexpr int LOG = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : R == 16 ? 4 : 5;
  if constexpr (INV) {
#pragma unroll
    for (int r = 0; r < R; ++r) vi[r] = -vi[r];
  }
  fft_reg<R, LOG>(vr, vi);
  if constexpr (INV) {
#pragma unroll
    for (int r = 0; r < R; ++r) vi[r] = -vi[r];
  }
}

// The 32-point DFT across the lanes, point by point, as decimation in
// frequency: lane order natural in, bit-reversed out. Stage i (span h =
// 16 >> i) multiplies the odd half of each pair by W_{2h}^{lane mod h}
// and the even half by 1 (xtw[i*32 + lane]), so that every lane runs the
// same instructions; the stage loop stays rolled, only the points unroll.
template <int R, bool INV>
__device__ __forceinline__ void lanes_dif(float (&vr)[R], float (&vi)[R], const float2* xtw,
                                          int lane) {
#pragma unroll 1
  for (int i = 0; i < 5; ++i) {
    const int h = 16 >> i;
    const float sg = (lane & h) ? -1.0f : 1.0f;
    const float2 w = xtw[i * 32 + lane];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float pr = __shfl_xor_sync(kFull, vr[r], h);
      const float pi = __shfl_xor_sync(kFull, vi[r], h);
      vr[r] = fmaf(sg, vr[r], pr);
      vi[r] = fmaf(sg, vi[r], pi);
      cmul<INV>(vr[r], vi[r], w);
    }
  }
}

// The same as decimation in time: lane order bit-reversed in, natural out.
template <int R, bool INV>
__device__ __forceinline__ void lanes_dit(float (&vr)[R], float (&vi)[R], const float2* xtw,
                                          int lane) {
#pragma unroll 1
  for (int i = 4; i >= 0; --i) {
    const int h = 16 >> i;
    const float sg = (lane & h) ? -1.0f : 1.0f;
    const float2 w = xtw[i * 32 + lane];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      cmul<INV>(vr[r], vi[r], w);
      const float pr = __shfl_xor_sync(kFull, vr[r], h);
      const float pi = __shfl_xor_sync(kFull, vi[r], h);
      vr[r] = fmaf(sg, vr[r], pr);
      vi[r] = fmaf(sg, vi[r], pi);
    }
  }
}

// H = sum_l g[l] W^{k l} of the subcarrier with w1 = W_N^k: L complex
// multiply-adds on the powers of w1 (0 without taps).
__device__ __forceinline__ float2 taps_response(const float2* g, int L, float2 w1) {
  if (L == 0) return make_float2(0.0f, 0.0f);
  float2 acc = g[0], wv = w1;
  for (int l = 1; l < L; ++l) {
    acc.x += g[l].x * wv.x - g[l].y * wv.y;
    acc.y += g[l].x * wv.y + g[l].y * wv.x;
    const float t = wv.x;
    wv.x = t * w1.x - wv.y * w1.y;
    wv.y = t * w1.y + wv.y * w1.x;
  }
  return acc;
}

// Waits for the G warps of a group (named barrier 1 + group; a group of
// one warp needs no barrier).
template <int G>
__device__ __forceinline__ void group_sync(int group) {
  if constexpr (G == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(32 * G) : "memory");
  }
}

// The SC-FDE (despread) equaliser of G's and C's forms, in three steps.
// The biased MMSE weight conj(h) / (|h|^2 + nv) of one tone; its bias
// term |h|^2 / (|h|^2 + nv) is added to g.
__device__ __forceinline__ float2 mmse_weight(float h_r, float h_i, float nv, float& g) {
  const float h2 = h_r * h_r + h_i * h_i, inv_d = 1.0f / (h2 + nv);
  g += h2 * inv_d;
  return make_float2(h_r * inv_d, -h_i * inv_d);
}

// A symbol's bias sum over its group of G warps: the lanes, then the
// group's warps in order, so the same bits on every run. slot: one float
// a warp of the block. Every lane of the group gets the sum, and the
// group's shared writes before the call are visible to it after.
template <int G>
__device__ __forceinline__ float group_bias_sum(float g, float* slot, int warp, int group,
                                                int lane) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) g += __shfl_down_sync(kFull, g, o);
  if constexpr (G == 1) {
    g = __shfl_sync(kFull, g, 0);
    __syncwarp();
    return g;
  } else {
    if (lane == 0) slot[warp] = g;
    group_sync<G>(group);
    g = 0.0f;
#pragma unroll
    for (int u = 0; u < G; ++u) g += slot[group * G + u];
    return g;
  }
}

// The despread's scale 1/(sqrt(N) b) and SINR b / max(1 - b, 1e-9) from
// the bias sum tot of an N-point symbol, b = max(tot / N, 1e-9).
__device__ __forceinline__ void despread_gain(float tot, int N, float& scale, float& sinr) {
  const float bias = fmaxf(tot / (float)N, 1e-9f);
  scale = (1.0f / sqrtf((float)N)) / bias;
  sinr = bias / fmaxf(1.0f - bias, 1e-9f);
}

// Fills the block's twiddle tables (every thread of the block takes part;
// the caller synchronises after): tw, N float2, W_N^{bitrev5(lane) (w + G
// r)} at position (r*G + w)*32 + lane; tw3, 32G float2, W_A^{c w} at
// w*32 + c (G > 1); xtw, 5 x 32 float2, the cross-lane stages' twiddles.
template <int R, int G>
__device__ __forceinline__ void build_tables(float2* tw, float2* tw3, float2* xtw,
                                             const float* __restrict__ twr,
                                             const float* __restrict__ twi, int log_n) {
  constexpr int N = 32 * R * G;
  // Position e holds point r of thread (w, lane): e >> 5 = r*G + w = a.
  for (int e = threadIdx.x; e < N; e += blockDim.x)
    tw[e] = w_table(twr, twi, log_n, brev5(e & 31) * (e >> 5));
  if (G > 1) {
    for (int e = threadIdx.x; e < 32 * G; e += blockDim.x)
      tw3[e] = w_table(twr, twi, log_n, (32 * (e >> 5) * (e & 31)) & (N - 1));
  }
  // Stage i of the cross-lane DFTs, span h = 16 >> i: W_{2h}^{lane mod h}
  // = W_N^{(lane mod h) N/(2h)} for a lane whose bit h is set, else 1.
  for (int e = threadIdx.x; e < 5 * 32; e += blockDim.x) {
    const int i = e >> 5, l = e & 31, h = 16 >> i;
    xtw[e] = (l & h) ? w_table(twr, twi, log_n, (l & (h - 1)) << (log_n - 5 + i))
                     : make_float2(1.0f, 0.0f);
  }
}

// The state of one thread: which points it holds and the tables it reads.
template <int R, int G>
struct Ctx {
  static constexpr int N = 32 * R * G;
  static constexpr int A = R * G;
  int lane, w, group;
  const float2* tw;
  const float2* tw3;
  const float2* xtw;
  float2* xch;  // the group's exchange buffer

  __device__ __forceinline__ int pos(int r) const { return (r * G + w) * 32 + lane; }
  // Index of point r of thread (w, lane) in the tone layout and in the
  // time layout.
  static __device__ __forceinline__ int f_at(int lane, int w, int r) { return A * lane + G * r + w; }
  static __device__ __forceinline__ int t_at(int lane, int w, int r) {
    return brev5(lane) + 32 * (w + G * (r / G)) + 32 * R * (r % G);
  }
  __device__ __forceinline__ int f_index(int r) const { return f_at(lane, w, r); }
  __device__ __forceinline__ int t_index(int r) const { return t_at(lane, w, r); }

  // x *= W_N^{bitrev5(lane) a} (INV: conjugate), a = w + G r.
  template <bool INV>
  __device__ __forceinline__ void twiddle_n(float (&vr)[R], float (&vi)[R]) const {
#pragma unroll
    for (int r = (G == 1 ? 1 : 0); r < R; ++r) cmul<INV>(vr[r], vi[r], tw[pos(r)]);
  }

  // T1 for G > 1, after the R-point DFT: x W_A^{c' w}, the exchange, and
  // the G-point DFTs over w (point j*G + d <- output d of transform j,
  // j indexing c' = w + G j).
  template <bool INV>
  __device__ __forceinline__ void cross_warp_t1(float (&vr)[R], float (&vi)[R]) const {
#pragma unroll
    for (int r = 0; r < R; ++r) cmul<INV>(vr[r], vi[r], tw3[w * 32 + r]);
    group_sync<G>(group);
#pragma unroll
    for (int r = 0; r < R; ++r) xch[(w * R + r) * 32 + lane] = make_float2(vr[r], vi[r]);
    group_sync<G>(group);
#pragma unroll
    for (int j = 0; j < R / G; ++j) {
      float ur[G], ui[G];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const float2 x = xch[(u * R + w + G * j) * 32 + lane];
        ur[u] = x.x;
        ui[u] = x.y;
      }
      fft_dir<G, INV>(ur, ui);
#pragma unroll
      for (int d = 0; d < G; ++d) {
        vr[j * G + d] = ur[d];
        vi[j * G + d] = ui[d];
      }
    }
  }

  // Its mirror at the start of T2.
  template <bool INV>
  __device__ __forceinline__ void cross_warp_t2(float (&vr)[R], float (&vi)[R]) const {
    group_sync<G>(group);
#pragma unroll
    for (int j = 0; j < R / G; ++j) {
      float ur[G], ui[G];
#pragma unroll
      for (int d = 0; d < G; ++d) {
        ur[d] = vr[j * G + d];
        ui[d] = vi[j * G + d];
      }
      fft_dir<G, INV>(ur, ui);
#pragma unroll
      for (int u = 0; u < G; ++u) xch[(u * R + w + G * j) * 32 + lane] = make_float2(ur[u], ui[u]);
    }
    group_sync<G>(group);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 x = xch[(w * R + r) * 32 + lane];
      vr[r] = x.x;
      vi[r] = x.y;
      cmul<INV>(vr[r], vi[r], tw3[w * 32 + r]);
    }
  }

  // Tone layout -> time layout, unscaled.
  template <bool INV>
  __device__ __forceinline__ void t1(float (&vr)[R], float (&vi)[R]) const {
    lanes_dif<R, INV>(vr, vi, xtw, lane);
    twiddle_n<INV>(vr, vi);
    fft_dir<R, INV>(vr, vi);
    if constexpr (G > 1) cross_warp_t1<INV>(vr, vi);
  }

  // Time layout -> tone layout, unscaled.
  template <bool INV>
  __device__ __forceinline__ void t2(float (&vr)[R], float (&vi)[R]) const {
    if constexpr (G > 1) cross_warp_t2<INV>(vr, vi);
    fft_dir<R, INV>(vr, vi);
    twiddle_n<INV>(vr, vi);
    lanes_dit<R, INV>(vr, vi, xtw, lane);
  }
};

}  // namespace sdr
