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
// Two forms share the tail. Up to N = 512 (the 32-channel mode) a block
// takes 32 adjacent channels and a run of symbols; the (N, 32) tile sits
// in shared memory and each of its transforms runs as sdr::smem_fft's
// radix-2 FFT down its column, the threads of a warp taking adjacent
// channels (a sample row is one 128-byte transaction). The tile is filled
// in bit-reversed row order (a warp's rows are adjacent in shared memory,
// so its stores do not conflict; rows of the sample plane are B·4 bytes
// apart, so the order costs the global reads nothing). The DIF bin order
// of the TPU kernel was a Mosaic artifact: bins here are natural.
//
// The wideband form (N = 1024, 2048, 4096; the TPU kernel took
// N = 128·2^k up to 4096 with h in bf16 to fit VMEM — here h stays f32)
// keeps the transform in registers. Radix plan N = 32 · 32 · r3, r3 =
// N/1024 (1, 2 or 4), as Stockham passes: a thread holds R = 32 points of
// one channel throughout, so a channel takes P = N/32 threads, and a
// block takes C = 2^14/N channels — 16, 8, 4 — as C·P = 512 threads,
// thread (t, c) = threadIdx t·C + c, so adjacent lanes take adjacent
// channels.
//   pass A: the thread loads samples t + r·P, r < 32, straight from the
//           plane into registers (64 independent loads in flight; a warp
//           reads 32/C rows of C·4 bytes) and runs a 32-point FFT there;
//   pass B: exchange through shared memory (Stockham: written at t·32 + r,
//           read at t + r·P), inter-pass twiddles W_N^{(t mod 32)·r·N/1024}
//           from the twr/twi table, a second 32-point FFT;
//   pass C: (N ≥ 2048) one more exchange, then 32/r3 radix-r3 DFTs of the
//           thread's own points with twiddles W_N^{j·r}.
// The thread ends with bins k = t + i·P, i < 32, in natural order, the
// same bins in every symbol. The exchange buffer holds one component of
// the tile at a time (the real parts, then the imaginary ones: four
// barriers an exchange, so 4 a symbol at N = 1024 and 8 above, against
// 10–12 radix-2 stages), padded by C words every 32 positions, which
// makes every write and read of it conflict-free. h for the block's
// channels is staged in shared memory once per run of kWideSyms symbols
// (natural order, channels minor) and read from there by the tail. Shared
// memory per block is 4·(N·33/32 + 2N)·C bytes, 194 KiB at every N: one
// block of 16 warps an SM, whose 64 loads a thread in flight cover the
// memory latency; __launch_bounds__(512) caps a thread at 128 registers,
// and loop-invariant addresses are kept from being hoisted (opaque()),
// which had spilled them. Eight channels a block at N = 4096 would need
// 256 KB of points, the whole register file: it keeps 4, so a block's
// row read or plane store covers 16 B of a 32-byte sector (8 B in bf16),
// the next block the other half. The blocks run as clusters of two
// adjacent channel groups, and for the plane at N >= 2048, where such
// narrow stores cost most, the pair works together: after the transform
// the two blocks swap halves of their spectra through distributed shared
// memory (16 points a thread into the partner's exchange buffer, between
// two cluster barriers), so each tail takes the pair's 2C channels over
// half the bins and a warp's store covers 2C adjacent channels of a row
// (64 B at N = 2048, 32 B at 4096, in f32). At N = 1024 (64-byte rows
// already) and for the sum and count the swap cost more than it saved,
// as measured on an NVIDIA H100 80GB HBM3 at 700 W. The sample, index and
// plane types are run-time arguments here (uniform branches around loads
// and stores), so each mode compiles once per modulation. Bound: the f32
// FFT and the max-log tail on CUDA cores, then the bytes; chip_smoke.py
// phase 2w prints each mode against kernel C on the same tones and
// against its bound.
// The cross-block sum is deterministic: one partial per block, then one
// block adds the partials in a fixed order — no float atomics, so
// repeated runs give the same bits.
//
// F shares D's transform and LLR forms, and compares each bit's
// hard decision (LLR < 0; in the wideband form taken by hard_bits, the
// LLR's sign without its magnitude) with the transmitted index plane
// idx_t (S*N, B) int8/int16 in natural bin order (the TPU kernel's DIF
// permutation of it is not carried over). The count is per channel: a
// thread always serves the same channel of its block, so it keeps an
// integer count in a register; at the end the threads of each channel
// are summed (in shared memory in the 32-channel mode, by warp shuffles
// in the wideband one) and added to out[b] with integer atomics — exact,
// and the same in any order.
//
// Bound on the H100: reading the two sample planes (8 bytes per sample
// in f32, 4 in bf16; F adds 1-2 bytes of index), and, close behind, the
// f32 FFT and tail on CUDA cores. In the 32-channel mode shared memory per
// block is 8·N·32 bytes (64 KB at N = 256, 128 KB at 512), which caps
// residency at three blocks per SM at N = 256 and one at 512 (bf16 input
// halves the bound, not the time: chip_smoke.py phase 2b).
#include <cuda_bf16.h>

#include <cooperative_groups.h>

#include "common.cuh"
#include "regfft.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSymsPerBlock = 8;  // symbols a 32-channel block runs
constexpr int kMaxLogN = 12;      // N <= 4096
constexpr int kLogChNarrow = 5;   // 32 channels a block up to N = 512
constexpr int kMaxLogNNarrow = 9;

constexpr int kWideR = 32;           // points a wideband thread holds
constexpr int kWideLogR = 5;
constexpr int kWideSyms = 16;        // symbols a wideband block runs (h staged once)
constexpr int kWideThreads = 512;     // threads a wideband block: 2^14 points / 32
constexpr int kWideLogTile = 14;     // N · channels of a wideband block
constexpr int kWideCluster = 2;      // blocks a wideband cluster (the plane's pair)

// log2 of the wideband channels per block: 16, 8, 4 at N = 1024, 2048, 4096.
__host__ __device__ __forceinline__ int wide_log_ch(int log_n) { return kWideLogTile - log_n; }

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
// store adjacent words. The 32-channel mode's load and transform.
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

using sdr::fft_reg;

// x *= W_N^m, 0 <= m < N, from the half-circle table (k < N/2).
__device__ __forceinline__ void mul_table(float& xr, float& xi, int m, int half,
                                          const float* __restrict__ twr,
                                          const float* __restrict__ twi) {
  const bool upper = m >= half;
  const int k = upper ? m - half : m;
  float wr = __ldg(twr + k), wi = __ldg(twi + k);
  if (upper) {
    wr = -wr;
    wi = -wi;
  }
  const float r = xr;
  xr = r * wr - xi * wi;
  xi = r * wi + xi * wr;
}

// v, hidden from the optimiser: what is computed from it inside a loop
// stays inside.
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}
__device__ __forceinline__ long long opaque(long long v) {
  asm volatile("" : "+l"(v));
  return v;
}

// Waits for every thread of the block's cluster (the pair of adjacent
// channel groups whose plane rows share sectors), its shared-memory
// stores, local or remote, then visible to both blocks.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\tbarrier.cluster.wait.acquire.aligned;"
               ::: "memory");
}

// One Stockham exchange of the wideband tile through shared memory: the
// thread's point i is written at word wbase + i·wstep and point i read
// back from rbase + i·rstep; the real parts first, then the imaginary
// ones, through the one buffer. The leading barrier keeps the buffer's
// last readers ahead of the first write.
__device__ __forceinline__ void exchange(float* buf, float (&vr)[kWideR], float (&vi)[kWideR],
                                         int wbase, int wstep, int rbase, int rstep) {
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kWideR; ++i) buf[wbase + i * wstep] = vr[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kWideR; ++i) vr[i] = buf[rbase + i * rstep];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kWideR; ++i) buf[wbase + i * wstep] = vi[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kWideR; ++i) vi[i] = buf[rbase + i * rstep];
}

// Pass C: the thread's 32/R3 radix-R3 DFTs j = t + q·P, inputs and outputs
// at points q + r·32/R3, twiddles W_N^{j·r}.
template <int R3, int LOG3>
__device__ __forceinline__ void last_pass(float (&vr)[kWideR], float (&vi)[kWideR], int t,
                                          int log_p, int half, const float* __restrict__ twr,
                                          const float* __restrict__ twi) {
  constexpr int Q = kWideR / R3;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = t + (q << log_p);
    float ur[R3], ui[R3];
#pragma unroll
    for (int r = 0; r < R3; ++r) {
      ur[r] = vr[q + r * Q];
      ui[r] = vi[q + r * Q];
      if (r) mul_table(ur[r], ui[r], j * r, half, twr, twi);
    }
    fft_reg<R3, LOG3>(ur, ui);
#pragma unroll
    for (int r = 0; r < R3; ++r) {
      vr[q + r * Q] = ur[r];
      vi[q + r * Q] = ui[r];
    }
  }
}

// The launch shape of every kernel here: (channel groups, symbol runs),
// the threads a block and its dynamic shared memory, opted in above 48 KB.
struct ClLaunch {
  dim3 grid;
  int threads;
  size_t smem;
};

__host__ inline ClLaunch cl_launch(int B, int S, int log_n) {
  const size_t N = (size_t)1 << log_n;
  if (log_n <= kMaxLogNNarrow) {
    const int n_ch = 1 << kLogChNarrow;
    return ClLaunch{dim3((B + n_ch - 1) / n_ch, (S + kSymsPerBlock - 1) / kSymsPerBlock),
                    sdr::kThreads, 2 * sizeof(float) * (N << kLogChNarrow)};
  }
  const int log_ch = wide_log_ch(log_n);
  const int n_ch = 1 << log_ch;
  const int groups = (B + n_ch - 1) / n_ch;
  return ClLaunch{dim3((groups + kWideCluster - 1) / kWideCluster * kWideCluster,
                       (S + kWideSyms - 1) / kWideSyms),
                  (int)(N >> kWideLogR) << log_ch,
                  sizeof(float) * ((N + (N >> 5) + 2 * N) << log_ch)};
}

// Max-log LLRs of one tone (channel c0 + c, bin k) into llr[0 ..
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

// The 32-channel mode's body: for each symbol of the block's run, the
// tile's load and transform, then f(s, k, b, llr) for each valid (bin k,
// channel b) of the tile, then a barrier before the next load.
template <int M, bool BPSK, typename InT, class F>
__device__ __forceinline__ void for_each_tone(const InT* __restrict__ re_t,
                                              const InT* __restrict__ im_t,
                                              const float* __restrict__ hr_t,
                                              const float* __restrict__ hi_t, int B, int S,
                                              int log_n, int cp, const sdr::AxisTables& tab,
                                              float inv_nv, const float* __restrict__ twr,
                                              const float* __restrict__ twi, F f) {
  constexpr int BPS = BPSK ? 1 : 2 * M;
  constexpr int log_ch = kLogChNarrow;
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

// Pass A's loads: samples o + r·step, r < 32, of the two planes, widened
// to f32; zeros for a thread past the last channel.
template <typename InT>
__device__ __forceinline__ void load_points(const InT* __restrict__ re_t,
                                            const InT* __restrict__ im_t, long long o,
                                            long long step, bool valid, float (&vr)[kWideR],
                                            float (&vi)[kWideR]) {
#pragma unroll
  for (int r = 0; r < kWideR; ++r) {
    vr[r] = valid ? to_f32(re_t[o + r * step]) : 0.0f;
    vi[r] = valid ? to_f32(im_t[o + r * step]) : 0.0f;
  }
}

// The wideband body (N = 1024, 2048, 4096; the radix plan of the header):
// h staged once, then for each symbol of the block's run the radix passes
// and f(s, k, b, yr, yi, h_r, h_i) for 32 tones a thread, each with its
// transform y and channel h, where channel b < B: the bins k = t + i·P of
// the thread's own channel, or in the pair tail those the lane is given.
// A thread past the last channel loads zeros and still takes its part in
// the exchanges.
template <bool PAIR_OK, class F>
__device__ __forceinline__ void for_each_tone_wide(const void* re_t, const void* im_t, int in_bf16,
                                                   const float* __restrict__ hr_t,
                                                   const float* __restrict__ hi_t, int B, int S,
                                                   int log_n, int cp, const float* __restrict__ twr,
                                                   const float* __restrict__ twi, F f) {
  extern __shared__ float smem[];
  const int log_ch = wide_log_ch(log_n);
  const int log_p = log_n - kWideLogR;
  const int N = 1 << log_n, P = 1 << log_p, C = 1 << log_ch;
  float* buf = smem;                                // (N + N/32)·C words, padded
  float* shr = smem + ((N + (N >> 5)) << log_ch);  // (N, C), channels minor
  float* shi = shr + (N << log_ch);
  const int c = threadIdx.x & (C - 1);
  const int t = threadIdx.x >> log_ch;
  const int c0 = blockIdx.x << log_ch;
  const int b = c0 + c;
  const bool valid = b < B;
  // The pair tail (PAIR_OK, at N >= 2048): this block (rank 0 or 1 of its
  // cluster) and its partner take channel groups 2·pair and 2·pair + 1,
  // and this block's tail takes half `rank` of the bins of the pair's 2C
  // channels. Otherwise the tail takes the block's own C channels.
  const bool pair = PAIR_OK && log_n >= 11;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int log_pair = log_ch + 1;
  const int pair_c0 = (blockIdx.x >> 1) << log_pair;
  const int half = N >> 1;
  // h, natural order, channels minor: the tail's channels and bins.
  const int h_log_ch = pair ? log_pair : log_ch;
  const int h_c0 = pair ? pair_c0 : c0;
  const int h_k0 = pair ? rank * half : 0;
  for (int e = threadIdx.x; e < (N << log_ch); e += blockDim.x) {
    const int bb = h_c0 + (e & ((1 << h_log_ch) - 1));
    const long long ho = (long long)(h_k0 + (e >> h_log_ch)) * B + bb;
    shr[e] = bb < B ? hr_t[ho] : 0.0f;
    shi[e] = bb < B ? hi_t[ho] : 0.0f;
  }  // the first exchange's barriers order these stores before the tail
  float* partner = cluster.map_shared_rank(buf, rank ^ 1);
  const long long row_step = (long long)P * B;
  for (int s = blockIdx.y * kWideSyms, s1 = min(S, s + kWideSyms); s < s1; ++s) {
    // The optimiser must not hoist what comes from these out of the symbol
    // loop: sets of 32 addresses or twiddles held across it spill.
    const int tt = opaque(t), cc = opaque(c), lc = opaque(log_ch);
    const long long step = opaque(row_step);
    // Buffer words: position pos of channel c at (pos + pos/32)·C + c. Pass
    // A writes pos t·32 + i; passes B and C read t + i·P; pass B writes
    // (t/32)·1024 + t mod 32 + 32·i.
    const int bc_r = ((tt + (tt >> 5)) << lc) + cc;
    const int bc_step = (P + (P >> 5)) << lc;
    float vr[kWideR], vi[kWideR];
    const long long o = ((long long)s * (N + cp) + cp + tt) * B + b;
    if (in_bf16)
      load_points(static_cast<const __nv_bfloat16*>(re_t), static_cast<const __nv_bfloat16*>(im_t),
                  o, step, valid, vr, vi);
    else
      load_points(static_cast<const float*>(re_t), static_cast<const float*>(im_t), o, step, valid,
                  vr, vi);
    fft_reg<kWideR, kWideLogR>(vr, vi);
    exchange(buf, vr, vi, ((tt * 33) << lc) + cc, 1 << lc, bc_r, bc_step);
    const int tw_b = (tt & 31) << (log_n - 10);
#pragma unroll
    for (int r = 1; r < kWideR; ++r) mul_table(vr[r], vi[r], tw_b * r, half, twr, twi);
    fft_reg<kWideR, kWideLogR>(vr, vi);
    if (log_n > 10) {
      exchange(buf, vr, vi, (((tt >> 5) * 1056 + (tt & 31)) << lc) + cc, 33 << lc, bc_r, bc_step);
      if (log_n == 11) last_pass<2, 1>(vr, vi, tt, log_p, half, twr, twi);
      else last_pass<4, 2>(vr, vi, tt, log_p, half, twr, twi);
    }
    if (!pair) {
      if (!valid) continue;
#pragma unroll
      for (int i = 0; i < kWideR; ++i) {
        const int k = tt + (i << log_p);
        f(s, k, b, vr[i], vi[i], shr[(k << lc) + cc], shi[(k << lc) + cc]);
      }
      continue;
    }
    // Halves through distributed shared memory: thread (t, c) sends the
    // points of the partner's half (i < 16 at rank 1, i >= 16 at rank 0)
    // to word i·512 + threadIdx of the partner's buffer, once both
    // transforms are done with the buffers.
    cluster_sync();
#pragma unroll
    for (int i = 0; i < kWideR / 2; ++i) {
      partner[i * kWideThreads + threadIdx.x] = rank ? vr[i] : vr[16 + i];
      partner[(16 + i) * kWideThreads + threadIdx.x] = rank ? vi[i] : vi[16 + i];
    }
    cluster_sync();
    // The tail over the pair's 2C channels and this half's bins: a warp
    // holds 32/C rows t of C channels; each of its two steps per point
    // takes 16/C of those rows across all 2C channels (lane = row · 2C +
    // channel), own channels shuffled from the lane that holds them, the
    // partner's read from the buffer, so a store covers 2C adjacent
    // channels of a row.
    const int lane = threadIdx.x & 31;
    const int ch2 = lane & ((2 << lc) - 1);
    const int cq = ch2 & ((1 << lc) - 1);
    const bool mine = (ch2 >> lc) == rank;
    const int bt = pair_c0 + ch2;
    const int t_w = (threadIdx.x >> 5) << (5 - lc);  // the warp's first row
#pragma unroll
    for (int i = 0; i < kWideR / 2; ++i) {
      const float own_r = rank ? vr[16 + i] : vr[i];
      const float own_i = rank ? vi[16 + i] : vi[i];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rw = (hh << (4 - lc)) + (lane >> (lc + 1));  // row within the warp
        const int src = (rw << lc) + cq;
        const float xr = __shfl_sync(0xffffffffu, own_r, src);
        const float xi = __shfl_sync(0xffffffffu, own_i, src);
        const float pr = buf[i * kWideThreads + (t_w << lc) + src];
        const float pi = buf[(16 + i) * kWideThreads + (t_w << lc) + src];
        const int kk = t_w + rw + (i << log_p);  // bin within the half
        if (bt < B)
          f(s, rank * half + kk, bt, mine ? xr : pr, mine ? xi : pi,
            shr[(kk << (lc + 1)) + ch2], shi[(kk << (lc + 1)) + ch2]);
      }
    }
  }
}

template <typename InT, int M, bool BPSK>
__global__ void __launch_bounds__(sdr::kThreads)
demod_sum_cl_kernel(const InT* __restrict__ re_t, const InT* __restrict__ im_t,
                    const float* __restrict__ hr_t, const float* __restrict__ hi_t,
                    float* __restrict__ partials, int B, int S, int log_n, int cp,
                    sdr::AxisTables tab, float inv_nv, const float* __restrict__ twr,
                    const float* __restrict__ twi) {
  constexpr int BPS = BPSK ? 1 : 2 * M;
  __shared__ float scratch[32];
  float acc = 0.0f;
  for_each_tone<M, BPSK>(re_t, im_t, hr_t, hi_t, B, S, log_n, cp, tab, inv_nv, twr, twi,
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
                  float* partials, int B, int S, int log_n, int cp, const sdr::AxisTables& tab,
                  float inv_nv, const float* twr, const float* twi, cudaStream_t st) {
  const ClLaunch l = cl_launch(B, S, log_n);
  cudaError_t err = opt_in(demod_sum_cl_kernel<InT, M, BPSK>, l.smem);
  if (err != cudaSuccess) return (int)err;
  demod_sum_cl_kernel<InT, M, BPSK><<<l.grid, l.threads, l.smem, st>>>(
      (const InT*)re_t, (const InT*)im_t, hr_t, hi_t, partials, B, S, log_n, cp, tab, inv_nv,
      twr, twi);
  return (int)cudaGetLastError();
}

template <typename IdxT, typename InT, int M, bool BPSK>
__global__ void __launch_bounds__(sdr::kThreads)
demod_count_cl_kernel(const InT* __restrict__ re_t, const InT* __restrict__ im_t,
                      const float* __restrict__ hr_t, const float* __restrict__ hi_t,
                      const IdxT* __restrict__ idx_t, int32_t* __restrict__ out, int B, int S,
                      int log_n, int cp, sdr::AxisTables tab, float inv_nv,
                      const float* __restrict__ twr, const float* __restrict__ twi) {
  __shared__ int partial[sdr::kThreads];
  constexpr int BPS = BPSK ? 1 : 2 * M;
  const int N = 1 << log_n;
  int err = 0;
  for_each_tone<M, BPSK>(re_t, im_t, hr_t, hi_t, B, S, log_n, cp, tab, inv_nv, twr, twi,
                         [&](int s, int k, int b, const float* llr) {
                           const int v = (int)idx_t[((long long)s * N + k) * B + b];
#pragma unroll
                           for (int j = 0; j < BPS; ++j)
                             err += (int)(llr[j] < 0.0f) != ((v >> (BPS - 1 - j)) & 1);
                         });
  partial[threadIdx.x] = err;
  __syncthreads();
  const int n_ch = 1 << kLogChNarrow;
  if ((int)threadIdx.x < n_ch) {
    int sum = 0;
    for (int w = threadIdx.x; w < (int)blockDim.x; w += n_ch) sum += partial[w];
    const int b = (blockIdx.x << kLogChNarrow) + threadIdx.x;
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
    cudaError_t err = opt_in(demod_count_cl_kernel<IdxT, InT, M, BPSK>, l.smem);
    if (err != cudaSuccess) return (int)err;
    demod_count_cl_kernel<IdxT, InT, M, BPSK><<<l.grid, l.threads, l.smem, st>>>(
        (const InT*)re_t, (const InT*)im_t, hr_t, hi_t, (const IdxT*)idx_t, out, B, S, log_n,
        cp, tab, inv_nv, twr, twi);
    return (int)cudaGetLastError();
  })
  return (int)cudaErrorInvalidValue;
}

// The LLR-plane mode (demod_cl_pallas.py::demod_llr_cl): D's transform
// and LLR forms, each LLR stored in the kernel order
//   out[((s * BPS + j) * N + k) * B + b]
// (per symbol, bit-major planes of natural-order bins, channels minor), so
// a warp's channels store contiguous runs of 4·ch (f32) or 2·ch (bf16)
// bytes. OutT is float or __nv_bfloat16 (round to nearest even, as torch's
// conversion).
template <typename OutT, typename InT, int M, bool BPSK>
__global__ void __launch_bounds__(sdr::kThreads)
demod_llr_cl_kernel(const InT* __restrict__ re_t, const InT* __restrict__ im_t,
                    const float* __restrict__ hr_t, const float* __restrict__ hi_t,
                    OutT* __restrict__ out, int B, int S, int log_n, int cp,
                    sdr::AxisTables tab, float inv_nv, const float* __restrict__ twr,
                    const float* __restrict__ twi) {
  constexpr int BPS = BPSK ? 1 : 2 * M;
  const int N = 1 << log_n;
  for_each_tone<M, BPSK>(re_t, im_t, hr_t, hi_t, B, S, log_n, cp, tab, inv_nv, twr, twi,
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
  cudaError_t err = opt_in(demod_llr_cl_kernel<OutT, InT, M, BPSK>, l.smem);
  if (err != cudaSuccess) return (int)err;
  demod_llr_cl_kernel<OutT, InT, M, BPSK><<<l.grid, l.threads, l.smem, st>>>(
      (const InT*)re_t, (const InT*)im_t, hr_t, hi_t, (OutT*)out, B, S, log_n, cp, tab, inv_nv,
      twr, twi);
  return (int)cudaGetLastError();
}

// The BPS LLRs of one tone at out[o + j·plane], rounded for a bf16 plane.
template <typename OutT, int BPS>
__device__ __forceinline__ void store_llrs(OutT* __restrict__ out, long long o, long long plane,
                                           const float* llr) {
#pragma unroll
  for (int j = 0; j < BPS; ++j) {
    if constexpr (sizeof(OutT) == 2) out[o + j * plane] = __float2bfloat16(llr[j]);
    else out[o + j * plane] = llr[j];
  }
}

// The hard decisions of one tone as a BPS-bit word, bit j (MSB first: the
// I bits, then the Q bits) set where the tone's max-log LLR j is negative.
// That is the sign of sdr::llr_axis_fold without its magnitudes: LLR_j < 0
// where z_j > 0, with z_0 the equalised axis over the PAM norm and
// z_{j+1} = L/2^{j+1} - |z_j|; here taken on w_j = z_j·|h|^2·norm, so
// w_0 = Re or Im of conj(h) y and no division is needed. It holds for every
// L (the division-free LLRs of L <= 4 have the same signs); rounding can
// flip only a bit whose LLR is 0 to rounding.
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

// The wideband kernels. The sample type (in_bf16), the index type
// (idx_bytes 1 or 2) and the plane's type (out_bf16) come at run time, as
// uniform branches around the loads and stores, so that each mode
// compiles once per modulation (18 kernels, not 72).
template <int M, bool BPSK>
__global__ void __launch_bounds__(kWideThreads)
demod_sum_cl_wide(const void* re_t, const void* im_t, int in_bf16,
                  const float* __restrict__ hr_t, const float* __restrict__ hi_t,
                  float* __restrict__ partials, int B, int S, int log_n, int cp,
                  sdr::AxisTables tab, float inv_nv, const float* __restrict__ twr,
                  const float* __restrict__ twi) {
  constexpr int BPS = BPSK ? 1 : 2 * M;
  __shared__ float scratch[32];
  float acc = 0.0f;
  for_each_tone_wide<false>(re_t, im_t, in_bf16, hr_t, hi_t, B, S, log_n, cp, twr, twi,
                     [&](int, int, int, float yr, float yi, float h_r, float h_i) {
                       float llr[BPS];
                       tone_llrs<M, BPSK>(yr, yi, h_r, h_i, inv_nv, tab, llr);
#pragma unroll
                       for (int j = 0; j < BPS; ++j) acc += llr[j];
                     });
  const float v = sdr::block_sum(acc, scratch);
  if (threadIdx.x == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = v;
}

template <int M, bool BPSK>
__global__ void __launch_bounds__(kWideThreads)
demod_count_cl_wide(const void* re_t, const void* im_t, int in_bf16,
                    const float* __restrict__ hr_t, const float* __restrict__ hi_t,
                    const void* idx_t, int idx_bytes, int32_t* __restrict__ out, int B, int S,
                    int log_n, int cp, sdr::AxisTables tab, float inv_nv,
                    const float* __restrict__ twr, const float* __restrict__ twi) {
  constexpr int BPS = BPSK ? 1 : 2 * M;
  const int N = 1 << log_n;
  const float norm = 1.0f / tab.inorm;
  int err = 0;
  for_each_tone_wide<false>(re_t, im_t, in_bf16, hr_t, hi_t, B, S, log_n, cp, twr, twi,
                     [&](int s, int k, int b, float yr, float yi, float h_r, float h_i) {
                       const long long o = ((long long)s * N + k) * B + b;
                       const int v = idx_bytes == 1 ? (int)static_cast<const int8_t*>(idx_t)[o]
                                                    : (int)static_cast<const int16_t*>(idx_t)[o];
                       const int bits = hard_bits<M, BPSK>(yr, yi, h_r, h_i, norm);
                       err += __popc((unsigned)((bits ^ v) & ((1 << BPS) - 1)));
                     });
  // Lanes c, c + C, ... of a warp serve channel c: shuffle-sum them into
  // lane c, which adds the warp's count for its channel.
  const int log_ch = wide_log_ch(log_n);
  for (int o = 16; o >= (1 << log_ch); o >>= 1) err += __shfl_down_sync(0xffffffffu, err, o);
  const int lane = threadIdx.x & 31;
  const int b = (blockIdx.x << log_ch) + lane;
  if (lane < (1 << log_ch) && b < B && err) atomicAdd(out + b, err);
}

template <int M, bool BPSK>
__global__ void __launch_bounds__(kWideThreads)
demod_llr_cl_wide(const void* re_t, const void* im_t, int in_bf16,
                  const float* __restrict__ hr_t, const float* __restrict__ hi_t, void* out,
                  int out_bf16, int B, int S, int log_n, int cp, sdr::AxisTables tab,
                  float inv_nv, const float* __restrict__ twr, const float* __restrict__ twi) {
  constexpr int BPS = BPSK ? 1 : 2 * M;
  const int N = 1 << log_n;
  for_each_tone_wide<true>(
      re_t, im_t, in_bf16, hr_t, hi_t, B, S, log_n, cp, twr, twi,
      [&](int s, int k, int b, float yr, float yi, float h_r, float h_i) {
        float llr[BPS];
        tone_llrs<M, BPSK>(yr, yi, h_r, h_i, inv_nv, tab, llr);
        const long long o = ((long long)s * BPS * N + k) * B + b;
        if (out_bf16) store_llrs<__nv_bfloat16, BPS>(static_cast<__nv_bfloat16*>(out), o,
                                                     (long long)N * B, llr);
        else store_llrs<float, BPS>(static_cast<float*>(out), o, (long long)N * B, llr);
      });
}

// Launches a wideband kernel as clusters of kWideCluster blocks, opted in
// to its 194 KiB of shared memory and to the largest shared-memory
// carveout.
template <class... P, class... A>
int launch_wide(void (*kernel)(P...), int B, int S, int log_n, cudaStream_t st, A... args) {
  const ClLaunch l = cl_launch(B, S, log_n);
  cudaError_t err = opt_in(kernel, l.smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = kWideCluster;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = l.grid;
  cfg.blockDim = dim3(l.threads);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = st;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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
    if (log_n > kMaxLogNNarrow)
      return launch_wide(demod_llr_cl_wide<M, BPSK>, B, S, log_n, st, re_t, im_t, in_bf16, hr_t,
                         hi_t, out, out_bf16, B, S, log_n, cp, tab, inv_nv, twr, twi);
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
  int rc = (int)cudaErrorInvalidValue;
  SDR_DISPATCH_MOD(bits_per_axis, bpsk,
    if (log_n > kMaxLogNNarrow)
      rc = launch_wide(demod_sum_cl_wide<M, BPSK>, B, S, log_n, st, re_t, im_t, in_bf16, hr_t,
                       hi_t, partials, B, S, log_n, cp, tab, inv_nv, twr, twi);
    else
      rc = with_in_type(in_bf16, [&](auto in) {
        return launch_sum_cl<decltype(in), M, BPSK>(re_t, im_t, hr_t, hi_t, partials, B, S,
                                                    log_n, cp, tab, inv_nv, twr, twi, st);
      }))
  if (rc != 0) return rc;
  sdr::sum_partials_kernel<<<1, 1024, 0, st>>>(partials, sdr_demod_sum_cl_partials(B, S, log_n),
                                               out);
  return (int)cudaGetLastError();
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
    if (log_n > kMaxLogNNarrow) {
      if (idx_bytes != 1 && idx_bytes != 2) return (int)cudaErrorInvalidValue;
      return launch_wide(demod_count_cl_wide<M, BPSK>, B, S, log_n, st, re_t, im_t, in_bf16,
                         hr_t, hi_t, idx_t, idx_bytes, out, B, S, log_n, cp, tab, inv_nv, twr,
                         twi);
    }
    return with_in_type(in_bf16, [&](auto in) {
      return launch_count_cl<decltype(in), M, BPSK>(re_t, im_t, hr_t, hi_t, idx_t, idx_bytes,
                                                    out, B, S, log_n, cp, tab, inv_nv, twr,
                                                    twi, st);
    }))
  return (int)cudaErrorInvalidValue;
}
