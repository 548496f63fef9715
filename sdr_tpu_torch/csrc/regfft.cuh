// Register-resident FFT pieces shared by kernels D/F (csrc/demod_cl.cu,
// the wideband form) and G (csrc/mc.cuh): small DFTs whose every index is
// a template constant, so the points stay in registers.
#pragma once
#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

namespace sdr {

// cos and sin of 2 pi k/32, k < 16, rounded to f32 (the values of the
// twr/twi tables at k·N/32).
__host__ __device__ constexpr float cos32(int k) {
  constexpr float t[16] = {1.0f, 0.9807852506637573f, 0.9238795042037964f,
                           0.8314695954322815f, 0.7071067690849304f, 0.5555702447891235f,
                           0.3826834261417389f, 0.19509032368659973f, 0.0f,
                           -0.19509032368659973f, -0.3826834261417389f, -0.5555702447891235f,
                           -0.7071067690849304f, -0.8314695954322815f, -0.9238795042037964f,
                           -0.9807852506637573f};
  return t[k];
}
__host__ __device__ constexpr float sin32(int k) { return cos32(k < 8 ? 8 - k : k - 8); }

// x *= W_R^K = e^{-2 pi i K/R}, K < R/2 (R a power of two, 2 to 32): 1 and -i cost
// no multiply, W^{R/8} and W^{3R/8} two, the others four.
template <int R, int K>
__device__ __forceinline__ void mul_w(float& xr, float& xi) {
  constexpr int K32 = K * (32 / R);  // the same angle on the 32-point circle
  const float r = xr, i = xi;
  if constexpr (K32 == 8) {  // -i
    xr = i;
    xi = -r;
  } else if constexpr (K32 == 4) {  // (1 - i)/sqrt 2
    xr = (r + i) * cos32(4);
    xi = (i - r) * cos32(4);
  } else if constexpr (K32 == 12) {  // (-1 - i)/sqrt 2
    xr = (i - r) * cos32(4);
    xi = -(r + i) * cos32(4);
  } else if constexpr (K32 != 0) {
    constexpr float c = cos32(K32), sn = sin32(K32);
    xr = r * c + i * sn;
    xi = i * c - r * sn;
  }
}

__host__ __device__ constexpr int bit_reverse_c(int i, int log) {
  int r = 0;
  for (int b = 0; b < log; ++b) r |= ((i >> b) & 1) << (log - 1 - b);
  return r;
}

// Butterfly J of the radix-2 DIT stage of half-width H.
template <int R, int H, int J>
__device__ __forceinline__ void butterfly(float (&ar)[R], float (&ai)[R]) {
  constexpr int P = J % H, A0 = (J / H) * 2 * H + P, A1 = A0 + H;
  float br = ar[A1], bi = ai[A1];
  mul_w<R, P * (R / (2 * H))>(br, bi);
  ar[A1] = ar[A0] - br;
  ai[A1] = ai[A0] - bi;
  ar[A0] += br;
  ai[A0] += bi;
}

// The stages of half-width H, 2H, ... R/2; every index a template constant,
// so the points stay in registers.
template <int R, int H, int... J>
__device__ __forceinline__ void dit_stages(float (&ar)[R], float (&ai)[R],
                                           std::integer_sequence<int, J...>) {
  (butterfly<R, H, J>(ar, ai), ...);
  if constexpr (2 * H < R) dit_stages<R, 2 * H>(ar, ai, std::make_integer_sequence<int, R / 2>{});
}

template <int R, int LOG, int... I>
__device__ __forceinline__ void fft_reg(float (&vr)[R], float (&vi)[R],
                                        std::integer_sequence<int, I...>) {
  float ar[R] = {vr[std::integral_constant<int, bit_reverse_c(I, LOG)>::value]...};
  float ai[R] = {vi[std::integral_constant<int, bit_reverse_c(I, LOG)>::value]...};
  dit_stages<R, 1>(ar, ai, std::make_integer_sequence<int, R / 2>{});
  ((vr[I] = ar[I], vi[I] = ai[I]), ...);
}

// Forward, unscaled R-point DFT of the R points a thread holds (R a power
// of two, 2 to 32), natural order in and out: radix-2 decimation in time
// on a bit-reversed copy, unrolled at compile time.
template <int R, int LOG>
__device__ __forceinline__ void fft_reg(float (&vr)[R], float (&vi)[R]) {
  fft_reg<R, LOG>(vr, vi, std::make_integer_sequence<int, R>{});
}

}  // namespace sdr
