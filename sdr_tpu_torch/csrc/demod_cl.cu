// Kernel D: channels-last demod + LLR sum (the headline receive terminal),
// and kernel F: channels-last demod + per-channel bit-error count, or the
// channels-last LLR plane.
//
// D replaces sdr_tpu/kernels/demod_cl_pallas.py::demod_sum_cl, F
// ::demod_count_cl and ::demod_llr_cl (all through _run_cl), the TPU's emit_pipeline
// kernel with DIF radix-2 levels down to 128-point leaf DFT matmuls.
// Same math on the same layout:
//   re_t, im_t (S*(N+cp), B) f32, symbol s in rows [s*(N+cp), (s+1)*(N+cp)),
//   the first cp rows of each symbol being the CP; hr_t, hi_t (N, B) in
//   natural bin order.
// Per (channel, symbol): CP strip; forward unscaled N-point FFT;
// p = conj(h) y; max-log LLRs — division-free for L <= 4 (the common
// p^2/|h|^2 term cancels), one reciprocal and the Gray fold recursion
// for L >= 8; every LLR added to the sum.
//
// A block takes 32 adjacent channels (one warp's width, so every load of
// a sample row is one 128-byte coalesced transaction) and a run of
// symbols; the (N, 32) tile sits in shared memory and each of the 32
// transforms runs as a radix-2 FFT down its column, bank-conflict-free
// because the 32 threads of a warp take the 32 channels. The DIF bin
// order of the TPU kernel was a Mosaic artifact: bins here are natural.
// The cross-block sum is deterministic: one partial per block, then one
// block adds the partials in a fixed order — no float atomics, so
// repeated runs give the same bits.
//
// F shares D's tile, transform and LLR forms, and compares each bit's
// hard decision (LLR < 0) with the transmitted index plane
// idx_t (S*N, B) int8/int16 in natural bin order (the TPU kernel's DIF
// permutation of it is not carried over). The count is per channel: a
// thread always serves the same channel of its block (the element loop
// strides by 256, a multiple of the 32-channel tile), so it keeps an
// integer count in a register; at the end the eight threads of each
// channel are summed in shared memory and added to out[b] with one
// integer atomic per channel and block — exact, and the same in any
// order.
//
// Bound on the H100: reading the two f32 sample planes (8 bytes per
// sample; F adds 1-2 bytes of index). Shared memory per block is 256*N
// bytes (64 KB at N = 256), which caps residency at three blocks per SM;
// that, and the f32 FFT on CUDA cores, are what stand between these
// kernels and the copy roofline.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kCh = 32;      // channels per block
constexpr int kLogCh = 5;
constexpr int kSymsPerBlock = 8;

// Gathers symbol s of the (N, 32-channel) tile into shared memory, bit-
// reversed, and transforms it (forward, unscaled).
__device__ __forceinline__ void load_fft_tile(const float* __restrict__ re_t,
                                              const float* __restrict__ im_t, int B, int s,
                                              int log_n, int cp, int c0, float* sre, float* sim,
                                              const float* __restrict__ twr,
                                              const float* __restrict__ twi) {
  const int N = 1 << log_n;
  const int sym_len = N + cp;
  for (int e = threadIdx.x; e < (N << kLogCh); e += blockDim.x) {
    const int c = e & (kCh - 1);
    const int n = e >> kLogCh;
    const int b = c0 + c;
    float xr = 0.0f, xi = 0.0f;
    if (b < B) {
      const long long o = ((long long)s * sym_len + cp + n) * B + b;
      xr = re_t[o];
      xi = im_t[o];
    }
    const int dst = (sdr::bit_reverse(n, log_n) << kLogCh) + c;
    sre[dst] = xr;
    sim[dst] = xi;
  }
  __syncthreads();
  sdr::smem_fft<true>(sre, sim, log_n, kLogCh, 1, kCh, twr, twi, 1.0f);
}

template <int M, bool BPSK>
__global__ void __launch_bounds__(sdr::kThreads)
demod_sum_cl_kernel(const float* __restrict__ re_t, const float* __restrict__ im_t,
                    const float* __restrict__ hr_t, const float* __restrict__ hi_t,
                    float* __restrict__ partials, int B, int S, int log_n, int cp,
                    sdr::AxisTables tab, float inv_nv, const float* __restrict__ twr,
                    const float* __restrict__ twi) {
  extern __shared__ float smem[];
  __shared__ float scratch[32];
  const int N = 1 << log_n;
  float* sre = smem;
  float* sim = smem + (N << kLogCh);
  const int c0 = blockIdx.x * kCh;
  const int s0 = blockIdx.y * kSymsPerBlock;
  const int s1 = min(S, s0 + kSymsPerBlock);
  float acc = 0.0f;

  for (int s = s0; s < s1; ++s) {
    load_fft_tile(re_t, im_t, B, s, log_n, cp, c0, sre, sim, twr, twi);

    for (int e = threadIdx.x; e < (N << kLogCh); e += blockDim.x) {
      const int c = e & (kCh - 1);
      const int k = e >> kLogCh;
      const int b = c0 + c;
      if (b >= B) continue;
      const long long ho = (long long)k * B + b;
      const float h_r = hr_t[ho], h_i = hi_t[ho];
      const float yr = sre[e], yi = sim[e];
      const float h2 = h_r * h_r + h_i * h_i;
      const float pr = h_r * yr + h_i * yi;
      const float pi = h_r * yi - h_i * yr;
      float llr[M];
      if constexpr (M <= 2) {
        sdr::llr_axis_dfree<M>(pr, h2, inv_nv, tab, llr);
#pragma unroll
        for (int j = 0; j < M; ++j) acc += llr[j];
        if constexpr (!BPSK) {
          sdr::llr_axis_dfree<M>(pi, h2, inv_nv, tab, llr);
#pragma unroll
          for (int j = 0; j < M; ++j) acc += llr[j];
        }
      } else {
        const float inv_h2 = 1.0f / fmaxf(h2, 1e-12f);
        const float inv_eff = h2 * inv_nv;
        sdr::llr_axis_fold<M>(pr * inv_h2, inv_eff, tab, llr);
#pragma unroll
        for (int j = 0; j < M; ++j) acc += llr[j];
        sdr::llr_axis_fold<M>(pi * inv_h2, inv_eff, tab, llr);
#pragma unroll
        for (int j = 0; j < M; ++j) acc += llr[j];
      }
    }
    __syncthreads();
  }
  const float v = sdr::block_sum(acc, scratch);
  if (threadIdx.x == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = v;
}

template <int M, bool BPSK>
int launch_sum_cl(const float* re_t, const float* im_t, const float* hr_t, const float* hi_t,
                  float* partials, float* out, int B, int S, int log_n, int cp,
                  const sdr::AxisTables& tab, float inv_nv, const float* twr, const float* twi,
                  cudaStream_t st) {
  const dim3 grid((B + kCh - 1) / kCh, (S + kSymsPerBlock - 1) / kSymsPerBlock);
  const size_t smem = (size_t)2 * sizeof(float) * ((size_t)kCh << log_n);
  cudaError_t err = cudaFuncSetAttribute(demod_sum_cl_kernel<M, BPSK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  demod_sum_cl_kernel<M, BPSK><<<grid, sdr::kThreads, smem, st>>>(
      re_t, im_t, hr_t, hi_t, partials, B, S, log_n, cp, tab, inv_nv, twr, twi);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sdr::sum_partials_kernel<<<1, 1024, 0, st>>>(partials, (int)(grid.x * grid.y), out);
  return (int)cudaGetLastError();
}

template <typename IdxT, int M, bool BPSK>
__global__ void __launch_bounds__(sdr::kThreads)
demod_count_cl_kernel(const float* __restrict__ re_t, const float* __restrict__ im_t,
                      const float* __restrict__ hr_t, const float* __restrict__ hi_t,
                      const IdxT* __restrict__ idx_t, int32_t* __restrict__ out, int B, int S,
                      int log_n, int cp, sdr::AxisTables tab, float inv_nv,
                      const float* __restrict__ twr, const float* __restrict__ twi) {
  extern __shared__ float smem[];
  __shared__ int partial[sdr::kThreads];
  constexpr int BPS = BPSK ? 1 : 2 * M;
  const int N = 1 << log_n;
  float* sre = smem;
  float* sim = smem + (N << kLogCh);
  const int c0 = blockIdx.x * kCh;
  const int s0 = blockIdx.y * kSymsPerBlock;
  const int s1 = min(S, s0 + kSymsPerBlock);
  int err = 0;

  for (int s = s0; s < s1; ++s) {
    load_fft_tile(re_t, im_t, B, s, log_n, cp, c0, sre, sim, twr, twi);
    for (int e = threadIdx.x; e < (N << kLogCh); e += blockDim.x) {
      const int c = e & (kCh - 1);
      const int k = e >> kLogCh;
      const int b = c0 + c;
      if (b >= B) continue;
      const long long ho = (long long)k * B + b;
      const float h_r = hr_t[ho], h_i = hi_t[ho];
      const float yr = sre[e], yi = sim[e];
      const float h2 = h_r * h_r + h_i * h_i;
      const float pr = h_r * yr + h_i * yi;
      const float pi = h_r * yi - h_i * yr;
      float llr[BPS];
      if constexpr (M <= 2) {
        sdr::llr_axis_dfree<M>(pr, h2, inv_nv, tab, llr);
        if constexpr (!BPSK) sdr::llr_axis_dfree<M>(pi, h2, inv_nv, tab, llr + M);
      } else {
        const float inv_h2 = 1.0f / fmaxf(h2, 1e-12f);
        const float inv_eff = h2 * inv_nv;
        sdr::llr_axis_fold<M>(pr * inv_h2, inv_eff, tab, llr);
        sdr::llr_axis_fold<M>(pi * inv_h2, inv_eff, tab, llr + M);
      }
      const int v = (int)idx_t[((long long)s * N + k) * B + b];
#pragma unroll
      for (int j = 0; j < BPS; ++j) err += (int)(llr[j] < 0.0f) != ((v >> (BPS - 1 - j)) & 1);
    }
    __syncthreads();
  }
  partial[threadIdx.x] = err;
  __syncthreads();
  if ((int)threadIdx.x < kCh) {
    int sum = 0;
    for (int w = threadIdx.x; w < (int)blockDim.x; w += kCh) sum += partial[w];
    const int b = c0 + threadIdx.x;
    if (b < B && sum) atomicAdd(out + b, sum);
  }
}

template <int M, bool BPSK>
int launch_count_cl(const float* re_t, const float* im_t, const float* hr_t, const float* hi_t,
                    const void* idx_t, int idx_bytes, int32_t* out, int B, int S, int log_n,
                    int cp, const sdr::AxisTables& tab, float inv_nv, const float* twr,
                    const float* twi, cudaStream_t st) {
  const dim3 grid((B + kCh - 1) / kCh, (S + kSymsPerBlock - 1) / kSymsPerBlock);
  const size_t smem = (size_t)2 * sizeof(float) * ((size_t)kCh << log_n);
  SDR_DISPATCH_IDX(idx_bytes, {
    cudaError_t err = cudaFuncSetAttribute(demod_count_cl_kernel<IdxT, M, BPSK>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    demod_count_cl_kernel<IdxT, M, BPSK><<<grid, sdr::kThreads, smem, st>>>(
        re_t, im_t, hr_t, hi_t, (const IdxT*)idx_t, out, B, S, log_n, cp, tab, inv_nv, twr,
        twi);
  })
  return (int)cudaGetLastError();
}

// The LLR-plane mode (demod_cl_pallas.py::demod_llr_cl): D's tile, transform
// and LLR forms, each LLR stored in the kernel order
//   out[((s * BPS + j) * N + k) * B + b]
// (per symbol, bit-major planes of natural-order bins, channels minor), so
// a warp's 32 channels store one contiguous 128-byte (f32) or 64-byte (bf16)
// run. OutT is float or __nv_bfloat16 (round to nearest even, as torch's
// conversion).
template <typename OutT, int M, bool BPSK>
__global__ void __launch_bounds__(sdr::kThreads)
demod_llr_cl_kernel(const float* __restrict__ re_t, const float* __restrict__ im_t,
                    const float* __restrict__ hr_t, const float* __restrict__ hi_t,
                    OutT* __restrict__ out, int B, int S, int log_n, int cp, sdr::AxisTables tab,
                    float inv_nv, const float* __restrict__ twr, const float* __restrict__ twi) {
  extern __shared__ float smem[];
  constexpr int BPS = BPSK ? 1 : 2 * M;
  const int N = 1 << log_n;
  float* sre = smem;
  float* sim = smem + (N << kLogCh);
  const int c0 = blockIdx.x * kCh;
  const int s0 = blockIdx.y * kSymsPerBlock;
  const int s1 = min(S, s0 + kSymsPerBlock);

  for (int s = s0; s < s1; ++s) {
    load_fft_tile(re_t, im_t, B, s, log_n, cp, c0, sre, sim, twr, twi);
    for (int e = threadIdx.x; e < (N << kLogCh); e += blockDim.x) {
      const int c = e & (kCh - 1);
      const int k = e >> kLogCh;
      const int b = c0 + c;
      if (b >= B) continue;
      const long long ho = (long long)k * B + b;
      const float h_r = hr_t[ho], h_i = hi_t[ho];
      const float yr = sre[e], yi = sim[e];
      const float h2 = h_r * h_r + h_i * h_i;
      const float pr = h_r * yr + h_i * yi;
      const float pi = h_r * yi - h_i * yr;
      float llr[BPS];
      if constexpr (M <= 2) {
        sdr::llr_axis_dfree<M>(pr, h2, inv_nv, tab, llr);
        if constexpr (!BPSK) sdr::llr_axis_dfree<M>(pi, h2, inv_nv, tab, llr + M);
      } else {
        const float inv_h2 = 1.0f / fmaxf(h2, 1e-12f);
        const float inv_eff = h2 * inv_nv;
        sdr::llr_axis_fold<M>(pr * inv_h2, inv_eff, tab, llr);
        sdr::llr_axis_fold<M>(pi * inv_h2, inv_eff, tab, llr + M);
      }
#pragma unroll
      for (int j = 0; j < BPS; ++j) {
        const long long o = (((long long)s * BPS + j) * N + k) * B + b;
        if constexpr (sizeof(OutT) == 2) out[o] = __float2bfloat16(llr[j]);
        else out[o] = llr[j];
      }
    }
    __syncthreads();
  }
}

template <typename OutT, int M, bool BPSK>
int launch_llr_cl(const float* re_t, const float* im_t, const float* hr_t, const float* hi_t,
                  void* out, int B, int S, int log_n, int cp, const sdr::AxisTables& tab,
                  float inv_nv, const float* twr, const float* twi, cudaStream_t st) {
  const dim3 grid((B + kCh - 1) / kCh, (S + kSymsPerBlock - 1) / kSymsPerBlock);
  const size_t smem = (size_t)2 * sizeof(float) * ((size_t)kCh << log_n);
  cudaError_t err = cudaFuncSetAttribute(demod_llr_cl_kernel<OutT, M, BPSK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  demod_llr_cl_kernel<OutT, M, BPSK><<<grid, sdr::kThreads, smem, st>>>(
      re_t, im_t, hr_t, hi_t, (OutT*)out, B, S, log_n, cp, tab, inv_nv, twr, twi);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sdr_demod_llr_cl(const float* re_t, const float* im_t, const float* hr_t,
                                const float* hi_t, void* out, int out_bf16, int B, int S,
                                int log_n, int cp, int bits_per_axis, int bpsk,
                                sdr::AxisTables tab, float inv_nv, const float* twr,
                                const float* twi, void* stream) {
  if (B == 0 || S == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  SDR_DISPATCH_MOD(bits_per_axis, bpsk,
    if (out_bf16)
      return launch_llr_cl<__nv_bfloat16, M, BPSK>(re_t, im_t, hr_t, hi_t, out, B, S, log_n, cp,
                                                   tab, inv_nv, twr, twi, st);
    return launch_llr_cl<float, M, BPSK>(re_t, im_t, hr_t, hi_t, out, B, S, log_n, cp, tab,
                                         inv_nv, twr, twi, st))
  return (int)cudaErrorInvalidValue;
}

// Number of per-block partials the wrapper must allocate.
extern "C" int sdr_demod_sum_cl_partials(int B, int S) {
  return ((B + kCh - 1) / kCh) * ((S + kSymsPerBlock - 1) / kSymsPerBlock);
}

extern "C" int sdr_demod_sum_cl(const float* re_t, const float* im_t, const float* hr_t,
                                const float* hi_t, float* partials, float* out, int B, int S,
                                int log_n, int cp, int bits_per_axis, int bpsk,
                                sdr::AxisTables tab, float inv_nv, const float* twr,
                                const float* twi, void* stream) {
  if (B == 0 || S == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  SDR_DISPATCH_MOD(bits_per_axis, bpsk,
    return launch_sum_cl<M, BPSK>(re_t, im_t, hr_t, hi_t, partials, out, B, S, log_n, cp, tab,
                                  inv_nv, twr, twi, st))
  return (int)cudaErrorInvalidValue;
}

extern "C" int sdr_demod_count_cl(const float* re_t, const float* im_t, const float* hr_t,
                                  const float* hi_t, const void* idx_t, int idx_bytes,
                                  int32_t* out, int B, int S, int log_n, int cp,
                                  int bits_per_axis, int bpsk, sdr::AxisTables tab,
                                  float inv_nv, const float* twr, const float* twi,
                                  void* stream) {
  if (B == 0 || S == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  SDR_DISPATCH_MOD(bits_per_axis, bpsk,
    return launch_count_cl<M, BPSK>(re_t, im_t, hr_t, hi_t, idx_t, idx_bytes, out, B, S, log_n,
                                    cp, tab, inv_nv, twr, twi, st))
  return (int)cudaErrorInvalidValue;
}
