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
// The sample planes may also come as bfloat16 (the JAX bench's default
// input, demod_cl_pallas.py:145): each sample is widened with
// __bfloat162float on load and everything after runs in f32, as for f32
// input; that halves the bytes the kernels must read.
// Per (channel, symbol): CP strip; forward unscaled N-point FFT;
// p = conj(h) y; max-log LLRs — division-free for L <= 4 (the common
// p^2/|h|^2 term cancels), one reciprocal and the Gray fold recursion
// for L >= 8; every LLR added to the sum.
//
// A block takes a group of adjacent channels and a run of symbols; the
// (N, channels) tile sits in shared memory and each of its transforms
// runs as a radix-2 FFT down its column, the threads of a warp taking
// adjacent channels. The group is a function of N, so that the tile stays
// at 128 KB (opted in with cudaFuncSetAttribute) up to N = 4096: 32
// channels up to N = 512 (one warp's width: a sample row is one 128-byte
// transaction), then 16 at N = 1024, 8 at 2048 and 4 at 4096 (the
// wideband mode; the TPU kernel took N = 128·2^k up to 4096 with h in
// bf16 to fit VMEM — here h stays f32). Below 32 channels a warp reads
// 32/ch rows of ch·4 bytes: at 4 channels 16 B of each 32-byte sector,
// the cost of keeping the whole transform in one block. The tile is
// filled in bit-reversed row order (a warp's rows are adjacent in shared
// memory, so its stores do not conflict; rows of the sample plane are
// B·4 bytes apart, so the order costs the global reads nothing); the
// FFT's first log2(32/ch) stages keep a 2-way bank conflict at ch < 32,
// left as it is. The DIF bin order of the TPU kernel was a Mosaic
// artifact: bins here are natural.
// The cross-block sum is deterministic: one partial per block, then one
// block adds the partials in a fixed order — no float atomics, so
// repeated runs give the same bits.
//
// F shares D's tile, transform and LLR forms, and compares each bit's
// hard decision (LLR < 0) with the transmitted index plane
// idx_t (S*N, B) int8/int16 in natural bin order (the TPU kernel's DIF
// permutation of it is not carried over). The count is per channel: a
// thread always serves the same channel of its block (the element loop
// strides by 256, a multiple of every channel group), so it keeps an
// integer count in a register; at the end the threads of each channel
// are summed in shared memory and added to out[b] with one integer
// atomic per channel and block — exact, and the same in any order.
//
// Bound on the H100: reading the two sample planes (8 bytes per sample
// in f32, 4 in bf16; F adds 1-2 bytes of index). Shared memory per block
// is 8·N·ch bytes (64 KB at N = 256, 128 KB from N = 512 on), which caps
// residency at three blocks per SM at N = 256 and one from N = 512 on;
// that, and the f32 FFT on CUDA cores, are what stand between these
// kernels and the copy roofline (bf16 input halves the bound, not the
// time: chip_smoke.py phase 2b).
#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kSymsPerBlock = 8;
constexpr int kMaxLogN = 12;  // N <= 4096
constexpr int kTileLog = 14;  // log2(N * channels) above N = 512: 128 KB of f32 pairs

constexpr int kLogChNarrow = 5;  // 32 channels a block up to N = 512

// log2 of the channels per block: 32 up to N = 512, then 2^14 / N.
__host__ __device__ __forceinline__ int log_channels(int log_n) {
  return log_n <= 9 ? kLogChNarrow : kTileLog - log_n;
}

// Calls f(std::integral_constant<int, LC>) with LC = 5 for the 32-channel
// tile (the index math of the load and the FFT then folds at compile
// time, as it did before the wideband mode) and LC = 0 for the wideband
// mode, whose channel count comes at run time. Each kernel takes
// log_ch = LC ? LC : its log_ch argument.
template <class F>
__host__ int with_log_ch(int log_ch, F f) {
  if (log_ch == kLogChNarrow) return f(std::integral_constant<int, kLogChNarrow>{});
  return f(std::integral_constant<int, 0>{});
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Calls f(InT{}) with the sample planes' element type: float, or
// __nv_bfloat16 when in_bf16.
template <class F>
__host__ int with_in_type(int in_bf16, F f) {
  if (in_bf16) return f(__nv_bfloat16{});
  return f(float{});
}

// Gathers symbol s of the (N, ch-channel) tile into shared memory, bit-
// reversed, and transforms it (forward, unscaled). Element m of a column
// holds sample bitrev(m); the loop runs over m, so the threads of a warp
// store adjacent words.
template <typename InT>
__device__ __forceinline__ void load_fft_tile(const InT* __restrict__ re_t,
                                              const InT* __restrict__ im_t, int B, int s,
                                              int log_n, int log_ch, int cp, int c0, float* sre,
                                              float* sim, const float* __restrict__ twr,
                                              const float* __restrict__ twi) {
  const int N = 1 << log_n;
  const int n_ch = 1 << log_ch;
  const int sym_len = N + cp;
#pragma unroll 4
  for (int e = threadIdx.x; e < (N << log_ch); e += blockDim.x) {
    const int c = e & (n_ch - 1);
    const int n = sdr::bit_reverse(e >> log_ch, log_n);
    const int b = c0 + c;
    float xr = 0.0f, xi = 0.0f;
    if (b < B) {
      const long long o = ((long long)s * sym_len + cp + n) * B + b;
      xr = to_f32(re_t[o]);
      xi = to_f32(im_t[o]);
    }
    sre[e] = xr;
    sim[e] = xi;
  }
  __syncthreads();
  sdr::smem_fft<true>(sre, sim, log_n, log_ch, 1, n_ch, twr, twi, 1.0f);
}

// The launch shape of every kernel here: (channel groups, symbol runs),
// and the dynamic shared memory of the tile, opted in above 48 KB.
struct ClLaunch {
  dim3 grid;
  size_t smem;
  int log_ch;
};

__host__ inline ClLaunch cl_launch(int B, int S, int log_n) {
  const int log_ch = log_channels(log_n);
  const int n_ch = 1 << log_ch;
  return ClLaunch{dim3((B + n_ch - 1) / n_ch, (S + kSymsPerBlock - 1) / kSymsPerBlock),
                  (size_t)2 * sizeof(float) * ((size_t)1 << (log_n + log_ch)), log_ch};
}

// Max-log LLRs of tile element e (channel c0 + c, bin k) into llr[0 ..
// BPS-1]: p = conj(h) y; the division-free form for L <= 4, one
// reciprocal and the Gray fold for L >= 8.
template <int M, bool BPSK>
__device__ __forceinline__ void tone_llrs(float yr, float yi, float h_r, float h_i, float inv_nv,
                                          const sdr::AxisTables& tab, float* llr) {
  const float h2 = h_r * h_r + h_i * h_i;
  const float pr = h_r * yr + h_i * yi;
  const float pi = h_r * yi - h_i * yr;
  if constexpr (M <= 2) {
    sdr::llr_axis_dfree<M>(pr, h2, inv_nv, tab, llr);
    if constexpr (!BPSK) sdr::llr_axis_dfree<M>(pi, h2, inv_nv, tab, llr + M);
  } else {
    const float inv_h2 = 1.0f / fmaxf(h2, 1e-12f);
    const float inv_eff = h2 * inv_nv;
    sdr::llr_axis_fold<M>(pr * inv_h2, inv_eff, tab, llr);
    sdr::llr_axis_fold<M>(pi * inv_h2, inv_eff, tab, llr + M);
  }
}

// The body every kernel here shares: for each symbol of the block's run,
// the tile's load and transform, then f(s, k, b, llr) for each valid
// (bin k, channel b) of the tile, then a barrier before the next load.
template <int M, bool BPSK, typename InT, class F>
__device__ __forceinline__ void for_each_tone(const InT* __restrict__ re_t,
                                              const InT* __restrict__ im_t,
                                              const float* __restrict__ hr_t,
                                              const float* __restrict__ hi_t, int B, int S,
                                              int log_n, int log_ch, int cp,
                                              const sdr::AxisTables& tab, float inv_nv,
                                              const float* __restrict__ twr,
                                              const float* __restrict__ twi, F f) {
  constexpr int BPS = BPSK ? 1 : 2 * M;
  extern __shared__ float smem[];
  const int N = 1 << log_n;
  const int n_ch = 1 << log_ch;
  float* sre = smem;
  float* sim = smem + (N << log_ch);
  const int c0 = blockIdx.x << log_ch;
  const int s0 = blockIdx.y * kSymsPerBlock;
  const int s1 = min(S, s0 + kSymsPerBlock);
  for (int s = s0; s < s1; ++s) {
    load_fft_tile(re_t, im_t, B, s, log_n, log_ch, cp, c0, sre, sim, twr, twi);
    for (int e = threadIdx.x; e < (N << log_ch); e += blockDim.x) {
      const int b = c0 + (e & (n_ch - 1));
      const int k = e >> log_ch;
      if (b >= B) continue;
      const long long ho = (long long)k * B + b;
      float llr[BPS];
      tone_llrs<M, BPSK>(sre[e], sim[e], hr_t[ho], hi_t[ho], inv_nv, tab, llr);
      f(s, k, b, llr);
    }
    __syncthreads();
  }
}

template <typename InT, int M, bool BPSK, int LC>
__global__ void __launch_bounds__(sdr::kThreads)
demod_sum_cl_kernel(const InT* __restrict__ re_t, const InT* __restrict__ im_t,
                    const float* __restrict__ hr_t, const float* __restrict__ hi_t,
                    float* __restrict__ partials, int B, int S, int log_n, int log_ch, int cp,
                    sdr::AxisTables tab, float inv_nv, const float* __restrict__ twr,
                    const float* __restrict__ twi) {
  constexpr int BPS = BPSK ? 1 : 2 * M;
  log_ch = LC ? LC : log_ch;
  __shared__ float scratch[32];
  float acc = 0.0f;
  for_each_tone<M, BPSK>(re_t, im_t, hr_t, hi_t, B, S, log_n, log_ch, cp, tab, inv_nv, twr, twi,
                         [&](int, int, int, const float* llr) {
#pragma unroll
                           for (int j = 0; j < BPS; ++j) acc += llr[j];
                         });
  const float v = sdr::block_sum(acc, scratch);
  if (threadIdx.x == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = v;
}

template <class K>
cudaError_t opt_in(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename InT, int M, bool BPSK>
int launch_sum_cl(const void* re_t, const void* im_t, const float* hr_t, const float* hi_t,
                  float* partials, float* out, int B, int S, int log_n, int cp,
                  const sdr::AxisTables& tab, float inv_nv, const float* twr, const float* twi,
                  cudaStream_t st) {
  const ClLaunch l = cl_launch(B, S, log_n);
  const int rc = with_log_ch(l.log_ch, [&](auto lc) {
    constexpr int LC = decltype(lc)::value;
    cudaError_t err = opt_in(demod_sum_cl_kernel<InT, M, BPSK, LC>, l.smem);
    if (err != cudaSuccess) return (int)err;
    demod_sum_cl_kernel<InT, M, BPSK, LC><<<l.grid, sdr::kThreads, l.smem, st>>>(
        (const InT*)re_t, (const InT*)im_t, hr_t, hi_t, partials, B, S, log_n, l.log_ch, cp,
        tab, inv_nv, twr, twi);
    return (int)cudaGetLastError();
  });
  if (rc != 0) return rc;
  sdr::sum_partials_kernel<<<1, 1024, 0, st>>>(partials, (int)(l.grid.x * l.grid.y), out);
  return (int)cudaGetLastError();
}

template <typename IdxT, typename InT, int M, bool BPSK, int LC>
__global__ void __launch_bounds__(sdr::kThreads)
demod_count_cl_kernel(const InT* __restrict__ re_t, const InT* __restrict__ im_t,
                      const float* __restrict__ hr_t, const float* __restrict__ hi_t,
                      const IdxT* __restrict__ idx_t, int32_t* __restrict__ out, int B, int S,
                      int log_n, int log_ch, int cp, sdr::AxisTables tab, float inv_nv,
                      const float* __restrict__ twr, const float* __restrict__ twi) {
  __shared__ int partial[sdr::kThreads];
  log_ch = LC ? LC : log_ch;
  constexpr int BPS = BPSK ? 1 : 2 * M;
  const int N = 1 << log_n;
  int err = 0;
  for_each_tone<M, BPSK>(re_t, im_t, hr_t, hi_t, B, S, log_n, log_ch, cp, tab, inv_nv, twr, twi,
                         [&](int s, int k, int b, const float* llr) {
                           const int v = (int)idx_t[((long long)s * N + k) * B + b];
#pragma unroll
                           for (int j = 0; j < BPS; ++j)
                             err += (int)(llr[j] < 0.0f) != ((v >> (BPS - 1 - j)) & 1);
                         });
  partial[threadIdx.x] = err;
  __syncthreads();
  const int n_ch = 1 << log_ch;
  if ((int)threadIdx.x < n_ch) {
    int sum = 0;
    for (int w = threadIdx.x; w < (int)blockDim.x; w += n_ch) sum += partial[w];
    const int b = (blockIdx.x << log_ch) + threadIdx.x;
    if (b < B && sum) atomicAdd(out + b, sum);
  }
}

template <typename InT, int M, bool BPSK>
int launch_count_cl(const void* re_t, const void* im_t, const float* hr_t, const float* hi_t,
                    const void* idx_t, int idx_bytes, int32_t* out, int B, int S, int log_n,
                    int cp, const sdr::AxisTables& tab, float inv_nv, const float* twr,
                    const float* twi, cudaStream_t st) {
  const ClLaunch l = cl_launch(B, S, log_n);
  SDR_DISPATCH_IDX(idx_bytes, {
    return with_log_ch(l.log_ch, [&](auto lc) {
      constexpr int LC = decltype(lc)::value;
      cudaError_t err = opt_in(demod_count_cl_kernel<IdxT, InT, M, BPSK, LC>, l.smem);
      if (err != cudaSuccess) return (int)err;
      demod_count_cl_kernel<IdxT, InT, M, BPSK, LC><<<l.grid, sdr::kThreads, l.smem, st>>>(
          (const InT*)re_t, (const InT*)im_t, hr_t, hi_t, (const IdxT*)idx_t, out, B, S, log_n,
          l.log_ch, cp, tab, inv_nv, twr, twi);
      return (int)cudaGetLastError();
    });
  })
  return (int)cudaErrorInvalidValue;
}

// The LLR-plane mode (demod_cl_pallas.py::demod_llr_cl): D's tile, transform
// and LLR forms, each LLR stored in the kernel order
//   out[((s * BPS + j) * N + k) * B + b]
// (per symbol, bit-major planes of natural-order bins, channels minor), so
// a warp's channels store contiguous runs of 4·ch (f32) or 2·ch (bf16)
// bytes. OutT is float or __nv_bfloat16 (round to nearest even, as torch's
// conversion).
template <typename OutT, typename InT, int M, bool BPSK, int LC>
__global__ void __launch_bounds__(sdr::kThreads)
demod_llr_cl_kernel(const InT* __restrict__ re_t, const InT* __restrict__ im_t,
                    const float* __restrict__ hr_t, const float* __restrict__ hi_t,
                    OutT* __restrict__ out, int B, int S, int log_n, int log_ch, int cp,
                    sdr::AxisTables tab, float inv_nv, const float* __restrict__ twr,
                    const float* __restrict__ twi) {
  constexpr int BPS = BPSK ? 1 : 2 * M;
  log_ch = LC ? LC : log_ch;
  const int N = 1 << log_n;
  for_each_tone<M, BPSK>(re_t, im_t, hr_t, hi_t, B, S, log_n, log_ch, cp, tab, inv_nv, twr, twi,
                         [&](int s, int k, int b, const float* llr) {
#pragma unroll
                           for (int j = 0; j < BPS; ++j) {
                             const long long o = (((long long)s * BPS + j) * N + k) * B + b;
                             if constexpr (sizeof(OutT) == 2) out[o] = __float2bfloat16(llr[j]);
                             else out[o] = llr[j];
                           }
                         });
}

template <typename OutT, typename InT, int M, bool BPSK>
int launch_llr_cl(const void* re_t, const void* im_t, const float* hr_t, const float* hi_t,
                  void* out, int B, int S, int log_n, int cp, const sdr::AxisTables& tab,
                  float inv_nv, const float* twr, const float* twi, cudaStream_t st) {
  const ClLaunch l = cl_launch(B, S, log_n);
  return with_log_ch(l.log_ch, [&](auto lc) {
    constexpr int LC = decltype(lc)::value;
    cudaError_t err = opt_in(demod_llr_cl_kernel<OutT, InT, M, BPSK, LC>, l.smem);
    if (err != cudaSuccess) return (int)err;
    demod_llr_cl_kernel<OutT, InT, M, BPSK, LC><<<l.grid, sdr::kThreads, l.smem, st>>>(
        (const InT*)re_t, (const InT*)im_t, hr_t, hi_t, (OutT*)out, B, S, log_n, l.log_ch, cp,
        tab, inv_nv, twr, twi);
    return (int)cudaGetLastError();
  });
}

bool bad_shape(int B, int S, int log_n) {
  return B <= 0 || S <= 0 || log_n < 1 || log_n > kMaxLogN;
}

}  // namespace

// re_t/im_t are float32, or bfloat16 when in_bf16, in every entry point.
extern "C" int sdr_demod_llr_cl(const void* re_t, const void* im_t, int in_bf16,
                                const float* hr_t, const float* hi_t, void* out, int out_bf16,
                                int B, int S, int log_n, int cp, int bits_per_axis, int bpsk,
                                sdr::AxisTables tab, float inv_nv, const float* twr,
                                const float* twi, void* stream) {
  if (bad_shape(B, S, log_n)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  SDR_DISPATCH_MOD(bits_per_axis, bpsk,
    return with_in_type(in_bf16, [&](auto in) {
      using InT = decltype(in);
      if (out_bf16)
        return launch_llr_cl<__nv_bfloat16, InT, M, BPSK>(re_t, im_t, hr_t, hi_t, out, B, S,
                                                          log_n, cp, tab, inv_nv, twr, twi, st);
      return launch_llr_cl<float, InT, M, BPSK>(re_t, im_t, hr_t, hi_t, out, B, S, log_n, cp,
                                                tab, inv_nv, twr, twi, st);
    }))
  return (int)cudaErrorInvalidValue;
}

// Number of per-block partials the sum's wrapper must allocate.
extern "C" int sdr_demod_sum_cl_partials(int B, int S, int log_n) {
  if (bad_shape(B, S, log_n)) return 0;
  const ClLaunch l = cl_launch(B, S, log_n);
  return (int)(l.grid.x * l.grid.y);
}

extern "C" int sdr_demod_sum_cl(const void* re_t, const void* im_t, int in_bf16,
                                const float* hr_t, const float* hi_t, float* partials,
                                float* out, int B, int S, int log_n, int cp, int bits_per_axis,
                                int bpsk, sdr::AxisTables tab, float inv_nv, const float* twr,
                                const float* twi, void* stream) {
  if (bad_shape(B, S, log_n)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  SDR_DISPATCH_MOD(bits_per_axis, bpsk,
    return with_in_type(in_bf16, [&](auto in) {
      return launch_sum_cl<decltype(in), M, BPSK>(re_t, im_t, hr_t, hi_t, partials, out, B, S,
                                                  log_n, cp, tab, inv_nv, twr, twi, st);
    }))
  return (int)cudaErrorInvalidValue;
}

extern "C" int sdr_demod_count_cl(const void* re_t, const void* im_t, int in_bf16,
                                  const float* hr_t, const float* hi_t, const void* idx_t,
                                  int idx_bytes, int32_t* out, int B, int S, int log_n, int cp,
                                  int bits_per_axis, int bpsk, sdr::AxisTables tab,
                                  float inv_nv, const float* twr, const float* twi,
                                  void* stream) {
  if (bad_shape(B, S, log_n)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  SDR_DISPATCH_MOD(bits_per_axis, bpsk,
    return with_in_type(in_bf16, [&](auto in) {
      return launch_count_cl<decltype(in), M, BPSK>(re_t, im_t, hr_t, hi_t, idx_t, idx_bytes,
                                                    out, B, S, log_n, cp, tab, inv_nv, twr,
                                                    twi, st);
    }))
  return (int)cudaErrorInvalidValue;
}
